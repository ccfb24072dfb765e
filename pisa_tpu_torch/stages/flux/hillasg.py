"""
Hillas-Gaisser H3a atmospheric flux (counterpart of
``pisa_tpu/stages/flux/hillasg.py``; reference
``pisa/stages/flux/hillasg.py``): 2-D (energy, coszen) flux tables with the
prompt nutau contributions, evaluated with the integral-preserving scheme
(``utils/flux_weights.py``) into 3-flavour (e, mu, tau) nominal fluxes.

The vendored table (``flux/hillas-h3a-taumode.d``) is the JAX package's
generated one (its ``scripts/make_h3a_table.py``); point ``flux_table`` at a
real table of the same "hg_taumode" format for production use.

The flux depends on the table and the containers' coordinates only, both
fixed at set-up, so set-up evaluates it on the host once and keeps it on
the containers' device; a compute writes those tensors (nothing is read on
the host, so a compiled template may trace the stage).
"""

from __future__ import annotations

import numpy as np

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.utils.flux_weights import (
    calculate_2d_flux_weights,
    load_2d_table,
)

__all__ = ["hillasg", "init_test"]

_ALL_NU = [
    "nue_cc", "numu_cc", "nutau_cc", "nue_nc", "numu_nc", "nutau_nc",
    "nuebar_cc", "numubar_cc", "nutaubar_cc", "nuebar_nc", "numubar_nc",
    "nutaubar_nc",
]
_PAIRS = (("nue", "nuebar"), ("numu", "numubar"), ("nutau", "nutaubar"))


def _host(tensor):
    return tensor.detach().cpu().numpy().astype(np.float64)


class hillasg(Stage):  # noqa: N801
    """Params: flux_table. Fills 3-flavour (e, mu, tau) nominal fluxes."""

    def __init__(self, **std_kwargs):
        super().__init__(
            expected_params=("flux_table",),
            expected_container_keys=("true_energy", "true_coszen"),
            **std_kwargs,
        )
        self.flux_table = None
        self._fluxes = {}

    host_param_names = ("flux_table",)

    def setup_function(self):
        self.flux_table = load_2d_table(str(self.params.flux_table.value))
        if self.is_map:
            self.data.link_containers("nu", _ALL_NU)
        self._fluxes = {}
        for container in self.data:
            e = _host(container["true_energy"])
            cz = np.clip(_host(container["true_coszen"]), -1, 1)
            nu = np.empty((e.size, 3), dtype=FTYPE)
            nubar = np.empty((e.size, 3), dtype=FTYPE)
            for i, (f, fbar) in enumerate(_PAIRS):
                nu[:, i] = calculate_2d_flux_weights(e, cz,
                                                     self.flux_table[f])
                nubar[:, i] = calculate_2d_flux_weights(
                    e, cz, self.flux_table[fbar])
            container["nu_flux_nominal"] = nu
            container["nubar_flux_nominal"] = nubar
            self._fluxes[container.name] = (container["nu_flux_nominal"],
                                            container["nubar_flux_nominal"])
        self.data.unlink_containers()

    def compute_function(self):
        if self.is_map:
            self.data.link_containers("nu", _ALL_NU)
        for container in self.data:
            nu, nubar = self._fluxes[container.name]
            container["nu_flux_nominal"] = nu
            container["nubar_flux_nominal"] = nubar
        self.data.unlink_containers()


def init_test(**param_kwargs):
    """Instantiation example (vendored generated H3a table)."""
    param_set = ParamSet([
        Param(name="flux_table", value="flux/hillas-h3a-taumode.d",
              **param_kwargs),
    ])
    return hillasg(params=param_set, calc_mode="events")
