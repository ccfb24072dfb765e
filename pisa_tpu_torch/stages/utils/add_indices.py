"""
Each event's flat bin index under the calc binning (counterpart of
``pisa_tpu/stages/utils/add_indices.py``; reference
``pisa/stages/utils/add_indices.py``, which stores one boolean mask per
bin): one (N,) integer tensor per container, 'bin_indices', with -1 for an
event below the binning in any dimension and the binning's size for one
above it. ``likelihood.generalized_llh_params`` reduces over it.
"""

from __future__ import annotations

from pisa_tpu_torch.core import translation
from pisa_tpu_torch.core.binning import MultiDimBinning
from pisa_tpu_torch.core.stage import Stage

__all__ = ["add_indices", "init_test"]


class add_indices(Stage):  # noqa: N801
    """Adds 'bin_indices' (flat index; -1 underflow, size overflow)."""

    def __init__(self, **std_kwargs):
        if not isinstance(std_kwargs.get("calc_mode"), MultiDimBinning):
            raise ValueError("add_indices requires a binning as calc_mode")
        if std_kwargs.get("apply_mode", "events") != "events":
            raise ValueError("apply_mode must be 'events'")
        std_kwargs.setdefault("apply_mode", "events")
        super().__init__(expected_params=(), expected_container_keys=(),
                         **std_kwargs)

    def setup_function(self):
        binning = self.calc_mode
        self.data.representation = "events"
        for container in self.data:
            sample = [container[name] for name in binning.names]
            container["bin_indices"] = translation.lookup_indices_flat(
                sample, binning)


def init_test(**param_kwargs):
    """Instantiation example."""
    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.core.binning import OneDimBinning

    binning = MultiDimBinning(
        [
            OneDimBinning(
                "true_energy", num_bins=5, is_log=True,
                domain=[1, 100] * ureg.GeV,
            )
        ],
        name="test",
    )
    return add_indices(calc_mode=binning, apply_mode="events")
