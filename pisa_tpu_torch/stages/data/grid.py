"""
Grid-of-points source (counterpart of ``pisa_tpu/stages/data/grid.py``;
reference ``pisa/stages/data/grid.py``): one container per output name
holding the points of a binning as "events" with unit weights, for
oscillograms.
"""

from __future__ import annotations

import numpy as np

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.container import Container
from pisa_tpu_torch.core.stage import Stage

__all__ = ["grid", "init_test"]


class grid(Stage):  # noqa: N801
    """Parameters: grid_binning (MultiDimBinning), entity, output_names.
    Events calc mode."""

    def __init__(self, grid_binning, entity="midpoints", output_names=None,
                 **std_kwargs):
        self.grid_binning = grid_binning
        self.entity = entity
        if output_names is None:
            raise ValueError("output_names must be given")
        self.output_names = output_names
        super().__init__(
            expected_params=(),
            expected_container_keys=(),
            **std_kwargs,
        )

    def setup_function(self):
        mesh = self.grid_binning.meshgrid(entity=self.entity,
                                          attach_units=False)
        size = mesh[0].size
        for name in self.output_names:
            container = Container(name, representation="events",
                                  device=self.data.device)
            nubar = -1 if "bar" in name else 1
            if "e" in name:
                flav = 0
            if "mu" in name:
                flav = 1
            if "tau" in name:
                flav = 2
            for var_name, var_vals in zip(self.grid_binning.names, mesh):
                container[var_name] = var_vals.ravel().astype(FTYPE)
            container.set_aux_data("nubar", nubar)
            container.set_aux_data("flav", flav)
            container["initial_weights"] = np.ones(size, dtype=FTYPE)
            container["weights"] = np.ones(size, dtype=FTYPE)
            self.data.add_container(container)

    def apply_function(self):
        for container in self.data:
            container["weights"] = container["initial_weights"] * 1.0


def init_test(**param_kwargs):
    """Instantiation example."""
    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.core.binning import MultiDimBinning, OneDimBinning

    binning = MultiDimBinning(
        [
            OneDimBinning("true_energy", num_bins=5, is_log=True,
                          domain=[1, 100] * ureg.GeV),
            OneDimBinning("true_coszen", num_bins=5, is_lin=True,
                          domain=[-1, 1]),
        ],
        name="grid_test",
    )
    return grid(grid_binning=binning, output_names=["nue_cc", "numu_cc"],
                calc_mode="events")
