"""
Meshes of ranks, event-axis sharding of compiled templates, and the batched
objective, on ``torch.distributed``.

Counterpart of ``pisa_tpu/parallel/sharding.py``. The JAX package places its
arrays over a ``jax.sharding.Mesh`` and lets XLA partition the compiled
template and insert the collectives. Torch has no such compiler, and the
port's kernels take plain tensors, so the port runs one process per device
(a rank) and places each collective itself:

- :class:`Mesh` is a 1-D mesh of ranks: the process group, its size, this
  process's place in it and its device (the card the process is bound to,
  ``torch.cuda.set_device``, or the CPU where the caller asks for it).
  :func:`default_mesh` makes one over the process group that
  :func:`pisa_tpu_torch.parallel.multihost.init_multihost` (or ``torchrun``
  and ``init_process_group``) set up.
- Each rank holds only its slice of the events: :func:`shard_containers`
  (a template that runs per container) and :func:`shard_stacked_containers`
  (the category-stacked template) cut the template's own containers to it.
  The histogram stage sums the ranks' partial histograms with one
  ``all_reduce`` (:meth:`Mesh.all_reduce_sum`, through the container's
  :class:`~pisa_tpu_torch.core.container.Shard`) before anything that is
  not linear in them; what comes after (hypersurfaces, the metric, the priors)
  runs on every rank on the whole template.
- Gradients: the ``all_reduce``'s backward sums the ranks' cotangents. Each
  rank's objective then carries 1/world of the total in its backward
  (:func:`scale_gradient`), and the gradient at the rescaled vector is
  summed over the ranks (:func:`sum_gradients`), so every rank holds the
  whole gradient and the value is the unscaled one
  (``core/collectives.py``). An identity backward
  would lose the other ranks' share of the event-side entries; a sum
  without the 1/world would count the entries after the reduction world
  times.
- :func:`build_batched_objective` splits a batch of walkers over the ranks,
  each evaluating its lanes (``core/template.py:wrap_objective``) on the
  whole template, and gathers the values.

Collectives on NCCL can be captured in a CUDA graph with the rest of a
``value_and_grad``; gloo's cannot, so a template sharded over a gloo group
runs with ``capture=False``, which its caller passes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from pisa_tpu_torch.core.collectives import (
    all_reduce_sum,
    scale_gradient,
    sum_gradients,
)
from pisa_tpu_torch.core.container import (
    Container,
    ContainerSet,
    Shard,
    _rep_hash,
    resolve_device,
)
from pisa_tpu_torch.utils.log import logging

__all__ = [
    "Mesh",
    "default_mesh",
    "shard_containers",
    "shard_stacked_containers",
    "build_batched_objective",
    "all_reduce_sum",
    "sum_gradients",
    "scale_gradient",
    "GRID_MIN",
]

#: the smallest calc grid whose points a stacked template splits over the
#: ranks (``pisa_tpu/parallel/sharding.py:146``); a smaller or indivisible
#: grid is computed whole on every rank
GRID_MIN = 8192


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ranks, one process each.

    group : the ``torch.distributed`` process group of the mesh's ranks
    ranks : the global ranks in the mesh, in mesh order
    rank : this process's index in the mesh (None if it is not in it)
    device : this process's device
    axis_name : the mesh axis's name (as the JAX package's ``Mesh`` has)
    """

    group: object
    ranks: tuple
    rank: int | None
    device: torch.device
    axis_name: str = "data"

    @property
    def size(self):
        return len(self.ranks)

    @property
    def backend(self):
        return dist.get_backend(self.group)

    def all_reduce_sum(self, x):
        """`x` summed over the ranks (``core/collectives.py``)."""
        return all_reduce_sum(x, self)


def default_mesh(n_devices=None, axis_name="data", device=None) -> Mesh:
    """A 1-D mesh over the first `n_devices` ranks of the process group
    (all of them by default, or ``PISA_TPU_NUM_DEVICES`` where that is
    set). The group must exist: this makes none. With fewer ranks than
    `n_devices` it raises, as the JAX package does with fewer devices. A
    mesh over fewer ranks than the group has is a new process group, which
    every rank of the group must ask for; on a rank outside it the mesh's
    ``rank`` is None.

    `device` is this process's: by default the card it is bound to
    (``init_multihost`` binds ``cuda:<local rank>``; without a card this
    raises, nothing falls back to the CPU), or ``"cpu"`` where the caller
    asks for it (a gloo world of processes on the CPU)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group: call pisa_tpu_torch."
            "parallel.multihost.init_multihost(...) in every process first")
    world = dist.get_world_size()
    if n_devices is None:
        from pisa_tpu_torch import PISA_TPU_NUM_DEVICES

        n_devices = PISA_TPU_NUM_DEVICES or world
    n_devices = int(n_devices)
    if world < n_devices:
        raise RuntimeError(f"need {n_devices} ranks; the process group has"
                           f" {world}")
    ranks = tuple(range(n_devices))
    group = (dist.group.WORLD if n_devices == world
             else dist.new_group(list(ranks)))
    me = dist.get_rank()
    return Mesh(group, ranks, ranks.index(me) if me in ranks else None,
                resolve_device("cuda" if device is None else device),
                axis_name)


def _member(mesh):
    if mesh.rank is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh of ranks"
                         f" {list(mesh.ranks)}")
    return mesh.rank


# -- per-container templates ------------------------------------------------------
def _events_size(container):
    ev_h = _rep_hash("events")
    sizes = {int(per[ev_h].shape[0]) for per in container._data.values()
             if ev_h in per and per[ev_h].dim() >= 1}
    if len(sizes) > 1:
        raise ValueError(f"container {container.name!r}: inconsistent"
                         f" events-axis sizes {sorted(sizes)}")
    return sizes.pop() if sizes else None


def _pad_container_events(container, n, coord_keys):
    """Pad every events-representation tensor of `container` so that its
    event axis is a multiple of `n`: binning coordinates with NaN (the bin
    search maps NaN to the overflow index, so padded events drop out of
    every histogram and lookup), integer and boolean tensors with 0, other
    floats with 0, so that ``weights * anything`` stays 0 there
    (``pisa_tpu/parallel/sharding.py:51``). The cached indices are dropped.
    In place, on the container it is given: :func:`shard_containers` gives
    it a copy. No-op when the axis already divides."""
    n_events = _events_size(container)
    if n_events is None:
        return
    pad = (-n_events) % n
    if pad == 0:
        return
    coord_keys = set(coord_keys)
    ev_h = _rep_hash("events")
    for key, per_rep in container._data.items():
        t = per_rep.get(ev_h)
        if t is None or t.dim() < 1:
            continue
        fill = (float("nan") if t.is_floating_point() and key in coord_keys
                else 0)
        per_rep[ev_h] = torch.cat(
            [t, torch.full((pad,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                           device=t.device)])
    container._flatidx.clear()
    container._flatidx_names.clear()
    logging.debug("container %s: padded events %d -> %d for %d ranks",
                  container.name, n_events, n_events + pad, n)


def _copy_container(container):
    """A container with `container`'s tensors (the same tensors, in dicts
    of its own) and no cached indices."""
    c = Container(container.name, representation=container.representation,
                  device=container.device)
    c._representations = dict(container._representations)
    c._data = {k: dict(v) for k, v in container._data.items()}
    c.validity = {k: dict(v) for k, v in container.validity.items()}
    c.translation_modes = dict(container.translation_modes)
    c._aux_data = dict(container._aux_data)
    return c


def shard_containers(data, mesh, axis_name="data", coord_keys=()):
    """A ContainerSet of this rank's slices of `data`'s containers, for a
    template that runs per container: each container's event axis is
    padded to a multiple of the mesh size (:func:`_pad_container_events`;
    pass the binning dimensions as `coord_keys`) and cut into equal
    contiguous slices, of which this rank takes its own. Binned tensors are
    kept whole on every rank (the events' lookups reach any of their
    points). `data` is not changed: the slices are of copies, so the
    pipeline's own containers, and its eager ``get_outputs()``, stay as
    they are (the JAX package pads the pipeline's containers in place)."""
    rank = _member(mesh)
    n = mesh.size
    ev_h = _rep_hash("events")
    out = ContainerSet(data.name, device=data.device)
    for k, v in data._glob_aux.items():
        out[k] = v
    for container in data.containers:
        c = _copy_container(container)
        _pad_container_events(c, n, coord_keys)
        n_events = _events_size(c)
        if n_events is None:
            events = (0, 0)
        else:
            per = n_events // n
            events = (rank * per, (rank + 1) * per)
            for per_rep in c._data.values():
                t = per_rep.get(ev_h)
                if t is not None and t.dim() >= 1:
                    per_rep[ev_h] = t[events[0]:events[1]]
        c.shard = Shard(mesh, events, n_events or 0)
        out.add_container(c)
    logging.debug("sharded %d containers over %d ranks (%s)",
                  len(out.containers), n, axis_name)
    return out


# -- the stacked template -----------------------------------------------------------
def _bounds(n, parts, i):
    """The `i`-th of `parts` contiguous near-equal slices of range(n)."""
    edges = np.linspace(0, n, parts + 1).round().astype(int)
    return int(edges[i]), int(edges[i + 1])


def shard_stacked_containers(data, mesh, axis_name="data", shard_grid=True,
                             grid_min=GRID_MIN):
    """Cut a STACKED ContainerSet (``core/stacking.py``, the template's own
    copy) to this rank's slice, in place:

    - the events-representation tensors ``(C, n_pad, ...)`` to this rank's
      slice of the padded event axis, which must divide by the mesh size
      (``build_stacked_set(pad_multiple=mesh size)`` makes it so; the pad
      slots drop out of every reduction);
    - where the histogram contracts the calc grid (rate deferral,
      ``stages/utils/hist.py``) and the grid has at least `grid_min` points
      that divide by the mesh size, with `shard_grid`, every tensor on the
      grid to this rank's slice of its flat points (axis 0 of a shared
      tensor, axis 1 of a grouped one): the oscillation stage then
      propagates only that slice, over chain geometry it builds for it. A
      smaller or indivisible grid is computed whole on every rank, as the
      JAX package replicates it. The port keeps its global layer indices in
      the stage's geometry, not in the containers, so nothing here holds
      them;
    - the rate-deferral matrices S and S2 to this rank's rows of the grid
      (its slice of a split grid, else a near-equal share of the whole
      grid's rows), so that the ranks' contractions sum to the whole; and
      each category's reference event, which gives its scalar factor, to
      the rank whose slice holds it: that rank contributes the factor to
      the histogram's ``all_reduce`` and the others 0, so no rank reads a
      padded or a foreign slot.

    The cached indices and one-hot matrices are dropped (the stages'
    ``prepare_stacked`` builds them again for the slice), and each container
    gets its :class:`pisa_tpu_torch.core.container.Shard`."""
    rank = _member(mesh)
    n = mesh.size
    ev_h = _rep_hash("events")
    for sc in data.containers:
        if not getattr(sc, "is_stacked", False):
            raise ValueError(
                f"container {sc.name!r} is not stacked; use shard_containers")
        n_pad = sc.n_pad
        if n_pad % n != 0:
            raise ValueError(
                f"stacked event padding n_pad={n_pad} is not divisible by"
                f" the {n} ranks of the mesh; rebuild the stacked set with"
                " build_stacked_set(pad_multiple=mesh size)")
        per = n_pad // n
        e0, e1 = rank * per, (rank + 1) * per
        defer = sc.rate_defer
        grids = {}
        if defer is not None:
            size = int(defer["S"].shape[1])
            split = shard_grid and size >= grid_min and size % n == 0
            g0, g1 = _bounds(size, n, rank)
            if split:
                grids[defer["grid"]] = (g0, g1)
            sc.rate_defer = _shard_rate_defer(defer, sc, (e0, e1), (g0, g1),
                                              split)
        for key, per_rep in sc._data.items():
            for h, t in per_rep.items():
                rows = sc.rows.get((key, h))
                if h == ev_h and t.dim() >= 2 and t.shape[1] == n_pad:
                    per_rep[h] = t[:, e0:e1]
                elif h in grids:
                    axis = 0 if rows is None else 1
                    g0, g1 = grids[h]
                    per_rep[h] = t.narrow(axis, g0, g1 - g0)
        sc.real_events = sc.real_events[:, e0:e1]
        sc.n_pad = per
        sc._flatidx.clear()
        sc._flatidx_names.clear()
        sc.shard = Shard(mesh, (e0, e1), n_pad, grids)
        logging.debug("stacked container %s sharded over %d ranks (%s): events"
                      " %s of %d, grid %s", sc.name, n, axis_name, (e0, e1),
                      n_pad, grids)


def _shard_rate_defer(defer, sc, events, rows, grid_split):
    """This rank's factorized-histogram inputs: S and S2 at its grid rows
    `rows`, the rate's slice to contract with them (None where the grid is
    split, and the rate is the rank's own already), and the reference
    events that lie in its event slice `events`."""
    e0, e1 = events
    g0, g1 = rows
    ref = defer["e0_event"]
    owned = np.flatnonzero((ref >= e0) & (ref < e1) & (defer["a0"] != 0))
    device = defer["S"].device

    def put(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return dict(
        defer,
        S=defer["S"][:, g0:g1].contiguous(),
        S2=defer["S2"][:, g0:g1].contiguous(),
        rate_slice=None if grid_split else (g0, g1),
        e0_cats=put(owned, torch.int64),
        e0=put(owned * (e1 - e0) + (ref[owned] - e0), torch.int64),
        inv_a0=put(1.0 / defer["a0"][owned], defer["S"].dtype),
    )


# -- the batched objective --------------------------------------------------------
def build_batched_objective(compiled_template, data_dist, metric, mesh=None,
                            axis_name="data", priors=True):
    """A ``(B, n_free) -> (B,)`` objective of many rescaled vectors at once
    (minimization convention, as ``CompiledTemplate.build_objective``): the
    port's counterpart of the reference's llh-server farm serving MCMC
    walkers (``pisa_tpu/parallel/sharding.py:255``).

    With a `mesh`, each rank evaluates its B / world walkers, as lanes of
    one program on the whole template (``value_only.raw_with_data``,
    ``core/template.py:wrap_objective``), and the values are gathered over
    the ranks; every rank must call it with the same vectors, and B must
    divide by the mesh size. With ``mesh=None`` it is the lanes on one
    device. The template must not be sharded itself (the walkers are split,
    not the events). Returns a (B,) float tensor on the template's
    device."""
    from pisa_tpu_torch.core.template import on_device

    ct = compiled_template
    if ct.mesh is not None:
        raise ValueError("build_batched_objective splits the walkers over the"
                         " ranks and evaluates each on the whole template;"
                         " give it a template that is not sharded")
    if mesh is not None and mesh.device != ct.device:
        raise ValueError(f"the mesh's device {mesh.device} is not the"
                         f" template's {ct.device}")
    value_only, _ = ct.build_objective(data_dist, metric, priors=priors)
    raw = value_only.raw_with_data

    def batched_objective(vecs):
        vecs = on_device(vecs, ct.device)
        if vecs.dim() != 2:
            raise ValueError(f"vecs must be (B, n_free); got"
                             f" {tuple(vecs.shape)}")
        los, his = ct._device_bounds()
        if mesh is None:
            with torch.no_grad():
                return raw(vecs, los, his)
        rank = _member(mesh)
        n_walkers = vecs.shape[0]
        if n_walkers % mesh.size:
            raise ValueError(
                f"{n_walkers} walkers do not divide over the {mesh.size} ranks"
                f" of the mesh ({axis_name!r}): each rank evaluates an equal"
                " share")
        per = n_walkers // mesh.size
        with torch.no_grad():
            values = raw(vecs[rank * per:(rank + 1) * per].contiguous(), los,
                         his).contiguous()
        gathered = [torch.empty_like(values) for _ in range(mesh.size)]
        dist.all_gather(gathered, values, group=mesh.group)
        return torch.cat(gathered)

    return batched_objective
