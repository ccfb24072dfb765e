"""
The differentiable collectives of a sharded template.

A sharded template (``parallel/sharding.py``) runs one process per device,
each holding its slice of the events. Its histogram stage sums the ranks'
partial histograms with :func:`all_reduce_sum`, and its objective
(``core/template.py``) carries the gradient rule: the ``all_reduce``'s
backward sums the ranks' cotangents, each rank's objective carries 1/world
of the total in its backward (:func:`scale_gradient`), and the gradient at
the rescaled vector is summed over the ranks (:func:`sum_gradients`). Every
rank then holds the whole gradient, and the value is the unscaled one.

Each function takes the mesh (``parallel.sharding.Mesh``) it reduces over;
nothing here makes one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "sum_gradients", "scale_gradient",
           "collective_count"]

#: collectives issued by :func:`all_reduce_sum` and :func:`sum_gradients`,
#: forward and backward (a replay of a captured program does not add to it)
collective_count = 0


def _group(mesh):
    if mesh.rank is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh of ranks"
                         f" {list(mesh.ranks)}")
    return mesh.group


class _AllReduce(torch.autograd.Function):
    """The sum over the ranks; the backward sums the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        global collective_count
        ctx.group = group
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        collective_count += 1
        return out

    @staticmethod
    def backward(ctx, g):
        global collective_count
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        collective_count += 1
        return g, None


class _SumGradients(torch.autograd.Function):
    """The identity; the backward sums the cotangent over the ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        global collective_count
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        collective_count += 1
        return g, None


class _ScaleGradient(torch.autograd.Function):
    """The identity; the backward scales the cotangent."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def all_reduce_sum(x, mesh):
    """`x` summed over the mesh's ranks, on every rank (one ``all_reduce``);
    differentiable: its backward sums the ranks' cotangents."""
    return _AllReduce.apply(x, _group(mesh))


def sum_gradients(x, mesh):
    """`x` as it is; in the backward, its gradient summed over the ranks."""
    return _SumGradients.apply(x, _group(mesh))


def scale_gradient(x, scale):
    """`x` as it is; in the backward, its gradient times `scale`."""
    return _ScaleGradient.apply(x, float(scale))
