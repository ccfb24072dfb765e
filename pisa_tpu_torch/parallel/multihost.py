"""
Several processes, on one host or many, as one mesh of ranks.

Counterpart of ``pisa_tpu/parallel/multihost.py``. The JAX package joins a
``jax.distributed`` cluster and forms a global mesh over every process's
devices. The port runs one process per device: every process calls
:func:`init_multihost`, which sets up the ``torch.distributed`` process
group (NCCL for a CUDA device, gloo for the CPU) and this process's device,
and :func:`global_mesh` is then the mesh of all the ranks.

Usage, one call per process (``torchrun --nproc-per-node N script.py`` sets
the rendezvous variables, and the call then needs no arguments):

    from pisa_tpu_torch.parallel import multihost
    multihost.init_multihost("host0:29500", num_processes=4, process_id=i)
    mesh = multihost.global_mesh()                      # on cuda:<i>
    block = multihost.make_global_array(events, mesh)   # this rank's block

Every process loads the same event files (PISA inputs are MC event tables,
not training corpora); :func:`make_global_array` keeps only this rank's
block of an array on its device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from pisa_tpu_torch import TORCH_FTYPE
from pisa_tpu_torch.core.container import resolve_device
from pisa_tpu_torch.parallel import sharding

__all__ = [
    "init_multihost",
    "global_mesh",
    "make_global_array",
    "process_local_slice",
    "GlobalArray",
]


#: how long a collective or the rendezvous waits for the other ranks
TIMEOUT = timedelta(minutes=10)


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, device=None, backend=None):
    """Join (or create) the process group; call once per process.

    coordinator_address : "host:port" of process 0's rendezvous (by default
        the ``MASTER_ADDR``/``MASTER_PORT`` that ``torchrun`` sets)
    num_processes, process_id : the world size and this process's rank (by
        default ``WORLD_SIZE`` and ``RANK``)
    device : this process's device: ``cuda:<LOCAL_RANK>`` by default (or
        the rank modulo the host's cards; a CUDA device without a card
        raises, nothing falls back to the CPU), or ``"cpu"``
    backend : ``"nccl"`` for a CUDA device and ``"gloo"`` for the CPU by
        default; gloo also takes CUDA tensors (several ranks on one card,
        which NCCL refuses), but its collectives cannot be captured

    On NCCL one ``all_reduce`` runs here, so that the communicator exists
    before a CUDA graph captures a collective. Returns (world size, rank).
    """
    global_rank = int(process_id if process_id is not None
                      else os.environ["RANK"])
    world = int(num_processes if num_processes is not None
                else os.environ["WORLD_SIZE"])
    if device is None:
        local = os.environ.get(
            "LOCAL_RANK", global_rank % max(1, torch.cuda.device_count()))
        device = f"cuda:{local}"
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    init_method = ("env://" if coordinator_address is None
                   else f"tcp://{coordinator_address}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=global_rank,
                            timeout=TIMEOUT)
    if backend == "nccl":
        probe = torch.ones(1, dtype=TORCH_FTYPE, device=device)
        dist.all_reduce(probe)
        torch.cuda.synchronize(device)
    return dist.get_world_size(), dist.get_rank()


def global_mesh(axis_name="data", device=None):
    """The mesh of every rank of the process group, in rank order, on this
    process's `device` (``sharding.default_mesh``: the card it is bound
    to by default, or ``"cpu"``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed process group: call"
                           " init_multihost(...) in every process first")
    return sharding.default_mesh(dist.get_world_size(), axis_name, device)


def process_local_slice(n_global, mesh, axis_name="data"):
    """(start, stop) of this rank's contiguous block of a length-`n_global`
    leading axis split over `mesh`; the length must divide by the mesh
    size."""
    n = mesh.size
    if n_global % n != 0:
        raise ValueError(f"global length {n_global} not divisible by {n}"
                         " ranks")
    rank = sharding._member(mesh)
    per = n_global // n
    return rank * per, (rank + 1) * per


@dataclass(frozen=True)
class GlobalArray:
    """This rank's block of an array split over a mesh, with the whole
    array's shape: a plain tensor (not a ``DTensor``: the port's kernels
    take plain tensors), which the caller combines with its own collective.

    local : this rank's block on its device (the whole array, replicated)
    global_shape : the whole array's shape
    start : where the block starts on the leading axis
    sharded : False where the array is replicated
    """

    local: torch.Tensor
    global_shape: tuple
    start: int
    sharded: bool


def make_global_array(host_array, mesh, axis_name="data"):
    """The :class:`GlobalArray` of a host array that every process holds
    whole (PISA's event tables are loaded alike everywhere): each rank keeps
    only its block of the leading axis on its device, or the whole array
    where that axis does not divide by the mesh size (replicated, as the
    JAX package replicates it). Floating arrays take ``TORCH_FTYPE``."""
    host_array = np.asarray(host_array)
    dtype = (TORCH_FTYPE if np.issubdtype(host_array.dtype, np.floating)
             else None)
    n = mesh.size
    if host_array.ndim >= 1 and host_array.shape[0] % n == 0 \
            and host_array.shape[0] >= n:
        start, stop = process_local_slice(host_array.shape[0], mesh,
                                          axis_name)
        block, sharded = host_array[start:stop], True
    else:
        start, block, sharded = 0, host_array, False
    local = torch.as_tensor(np.ascontiguousarray(block), dtype=dtype,
                            device=mesh.device)
    return GlobalArray(local, tuple(host_array.shape), start, sharded)
