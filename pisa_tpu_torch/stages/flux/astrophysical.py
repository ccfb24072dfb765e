"""
Astrophysical single-power-law flux (counterpart of
``pisa_tpu/stages/flux/astrophysical.py``; reference
``pisa/stages/flux/astrophysical.py``): the nominal flux 0.787e-18 (E /
100 TeV)^-2.5 per flavour, tilted by ``astro_delta`` and scaled by
``astro_norm`` in torch ops (both differentiable); fills ``astro_weights``,
which ``utils.hist`` adds to the weights.
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type

__all__ = ["astrophysical", "init_test"]

PIVOT = FTYPE(100.0e3)  # 100 TeV in GeV


class astrophysical(Stage):  # noqa: N801
    """Params: astro_delta, astro_norm."""

    def __init__(self, **std_kwargs):
        self._central_gamma = FTYPE(-2.5)
        self._central_norm = FTYPE(0.787e-18)
        super().__init__(
            expected_params=("astro_delta", "astro_norm"),
            expected_container_keys=(
                "true_energy", "true_coszen", "initial_weights",
            ),
            **std_kwargs,
        )

    def setup_function(self):
        for container in self.data:
            e = container["true_energy"].detach().cpu().numpy().astype(
                np.float64)
            container["astro_flux_nominal"] = (
                self._central_norm * np.power(e / PIVOT, self._central_gamma)
            ).astype(FTYPE)
            container["astro_weights"] = np.ones(container.size, dtype=FTYPE)

    def compute_function(self):
        delta = in_data_type(self.params.astro_delta.m_as("dimensionless"))
        norm = in_data_type(self.params.astro_norm.m_as("dimensionless"))
        for container in self.data:
            scale = torch.pow(container["true_energy"] / PIVOT, delta)
            container["astro_flux"] = (
                norm * container["astro_flux_nominal"] * scale)

    def apply_function(self):
        for container in self.data:
            container["astro_weights"] = (
                container["initial_weights"] * container["astro_flux"])


def init_test(**param_kwargs):
    """Instantiation example."""
    param_set = ParamSet([
        Param(name="astro_norm", value=1.0, **param_kwargs),
        Param(name="astro_delta", value=0.0, **param_kwargs),
    ])
    return astrophysical(params=param_set)
