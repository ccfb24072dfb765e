"""
Multi-device evaluation on ``torch.distributed`` (counterpart of
``pisa_tpu/parallel``).

The reference scales template and llh evaluation with a farm of forked TCP
socket servers (``pisa/utils/llh_server.py:64-120``; the port serves that
use with ``utils/llh_server.py:fork_servers``). Here, one process per
device:

- :func:`default_mesh`: a 1-D mesh over the ranks of the process group;
- :meth:`CompiledTemplate.shard` (through :func:`shard_containers` and
  :func:`shard_stacked_containers`): each rank holds its slice of the event
  axis (and of a large calc grid), and the histogram stage sums the ranks'
  partial histograms with one ``all_reduce`` (``parallel/sharding.py``);
- :func:`build_batched_objective`: the walkers of a batch split over the
  ranks, each evaluating its lanes on the whole template;
- :mod:`multihost`: the process group over several processes and hosts.
"""

from pisa_tpu_torch.parallel.sharding import (
    build_batched_objective,
    default_mesh,
    shard_containers,
    shard_stacked_containers,
)
from pisa_tpu_torch.parallel import multihost

__all__ = [
    "default_mesh",
    "shard_containers",
    "shard_stacked_containers",
    "build_batched_objective",
    "multihost",
]
