"""
Atmospheric-muon background systematics (counterpart of
``pisa_tpu/stages/background/atm_muons.py``; reference
``pisa/stages/background/atm_muons.py``): an overall normalization and a
primary-cosmic-ray spectral-index reweight from a splined 1-sigma
uncertainty table in coszen (scipy ``interp1d`` on the host at set-up; the
table is read in place from the resources).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.interpolate import interp1d

from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type
from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["atm_muons", "init_test"]


class atm_muons(Stage):  # noqa: N801
    """Params: atm_muon_scale, delta_gamma_mu(_file/_spline_kind/_variable)."""

    def __init__(self, input_names=None, **std_kwargs):
        self.input_names = input_names
        super().__init__(
            expected_params=(
                "atm_muon_scale",
                "delta_gamma_mu_file",
                "delta_gamma_mu_spline_kind",
                "delta_gamma_mu_variable",
                "delta_gamma_mu",
            ),
            expected_container_keys=("true_coszen", "weights"),
            **std_kwargs,
        )
        self.prim_unc_spline = None

    host_param_names = (
        "delta_gamma_mu_file", "delta_gamma_mu_spline_kind",
        "delta_gamma_mu_variable",
    )

    def setup_function(self):
        self.prim_unc_spline = self._make_prim_unc_spline()
        rw_variable = str(self.params["delta_gamma_mu_variable"].value)

        for container in self.data:
            rw = self.prim_unc_spline(np.abs(
                container[rw_variable].cpu().numpy().astype(np.float64)))
            # normalize the (positive-only) reweight to mean zero
            container["cr_rw_array"] = rw - rw.mean()

    def apply_function(self):
        scale = in_data_type(
            self.params["atm_muon_scale"].value.m_as("dimensionless"))
        cr_rw_scale = in_data_type(
            self.params["delta_gamma_mu"].value.m_as("dimensionless"))
        for container in self.data:
            weight_mod = 1.0 + cr_rw_scale * container["cr_rw_array"]
            container["weights"] = container["weights"] * torch.clamp(
                weight_mod * scale, min=0.0
            )

    def _make_prim_unc_spline(self):
        """1-sigma spectral-index uncertainty vs |coszen|
        (reference ``atm_muons.py:_make_prim_unc_spline``)."""
        var = str(self.params["delta_gamma_mu_variable"].value)
        bare = var.split("true_")[-1]
        if bare != "coszen":
            raise ValueError(
                "muon primary CR systematic only implemented vs coszen;"
                f" got {var!r}"
            )
        fname = str(self.params["delta_gamma_mu_file"].value)
        if bare not in fname:
            raise ValueError(
                f"variable {var!r} not referenced by file {fname!r}"
            )
        uncdata = np.genfromtxt(find_resource(fname)).T
        # replace zero entries (no MC) with nearest non-zero neighbor
        while 0.0 in uncdata[1]:
            for i in np.where(uncdata[1] == 0)[0]:
                uncdata[1][i] = uncdata[1][i + 1]
        xvals = np.concatenate([[0.0], uncdata[0], [1.0]])
        yvals = np.concatenate([[uncdata[1][0]], uncdata[1], [uncdata[1][-1]]])
        return interp1d(
            xvals, yvals,
            kind=str(self.params["delta_gamma_mu_spline_kind"].value),
        )


def init_test(**param_kwargs):
    """Instantiation example."""
    param_set = ParamSet(
        [
            Param(name="atm_muon_scale", value=1.0, **param_kwargs),
            Param(
                name="delta_gamma_mu_file",
                value="background/muongun_primary_cr_uncertainties_coszenith.txt",
                **param_kwargs,
            ),
            Param(
                name="delta_gamma_mu_spline_kind", value="linear",
                **param_kwargs,
            ),
            Param(
                name="delta_gamma_mu_variable", value="true_coszen",
                **param_kwargs,
            ),
            Param(name="delta_gamma_mu", value=1.0, **param_kwargs),
        ]
    )
    return atm_muons(input_names="muon", params=param_set)
