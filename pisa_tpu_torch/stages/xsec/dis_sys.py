"""
Deep-inelastic-scattering cross-section systematics (counterpart of
``pisa_tpu/stages/xsec/dis_sys.py``; reference
``pisa/stages/xsec/dis_sys.py``): per-event total and differential CSMS
corrections from the vendored polynomial and ``SmoothBivariateSpline``
pickles, extrapolated below a threshold energy (``extrapolation_type``
"constant", "linear" or "higher"), evaluated on the host at set-up; the
weights are ``weights *= max(0, (1 + tot p_tot)(1 + diff p_diff))`` in
torch ops, differentiable in the parameters. Events only, as the JAX
stage.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from pisa_tpu_torch import FTYPE, ureg
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type
from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["dis_sys", "init_test"]

_SPLINES = "cross_sections/dis_csms_splines_flat_no_nucl_corr/"


def _load_pickle(path):
    with open(find_resource(path), "rb") as fl:
        return pickle.load(fl, encoding="latin1")


def _host(tensor):
    return tensor.detach().cpu().numpy().astype(np.float64)


class dis_sys(Stage):  # noqa: N801
    """Params: dis_csms (combined) or dis_csms_tot + dis_csms_diff."""

    def __init__(
        self,
        extrapolation_type="constant",
        extrapolation_energy_threshold=100 * ureg.GeV,
        combine_components=True,
        **std_kwargs,
    ):
        expected_params = (
            ("dis_csms",)
            if combine_components
            else ("dis_csms_tot", "dis_csms_diff")
        )
        super().__init__(
            expected_params=expected_params,
            expected_container_keys=(
                "true_energy", "bjorken_y", "dis", "nubar", "weights",
            ),
            **std_kwargs,
        )
        self.supported_reps = {"calc_mode": ["events"]}
        self.extrapolation_type = extrapolation_type
        self.extrapolation_energy_threshold = extrapolation_energy_threshold
        self.combine_components = combine_components

    def setup_function(self):
        extrap = _load_pickle(
            "cross_sections/tot_xsec_corr_Q2min1_isoscalar.pckl")
        splines = {
            ("CC", 1): _load_pickle(_SPLINES + "NuMu_CC_flat.pckl"),
            ("CC", -1): _load_pickle(_SPLINES + "NuMu_Bar_CC_flat.pckl"),
            ("NC", 1): _load_pickle(_SPLINES + "NuMu_NC_flat.pckl"),
            ("NC", -1): _load_pickle(_SPLINES + "NuMu_Bar_NC_flat.pckl"),
        }
        self.data.representation = "events"
        lg_e_min = np.log10(self.extrapolation_energy_threshold.m_as("GeV"))
        for container in self.data:
            if container.name.endswith("_cc"):
                current = "CC"
            elif container.name.endswith("_nc"):
                current = "NC"
            else:
                raise ValueError(
                    f"cannot infer CC/NC from container {container.name!r}")
            nubar = int(container["nubar"])
            nu_key = "Nu" if nubar > 0 else "NuBar"
            lg_e = np.log10(_host(container["true_energy"]))
            bjorken_y = _host(container["bjorken_y"])
            dis = _host(container["dis"])
            valid = lg_e >= lg_e_min

            poly = extrap[nu_key][current]["poly_coef"]
            lin = extrap[nu_key][current]["linear"]
            w_tot = np.ones_like(lg_e)
            if self.extrapolation_type == "higher":
                w_tot = np.polyval(poly, lg_e)
            else:
                w_tot[valid] = np.polyval(poly, lg_e[valid])
                if self.extrapolation_type == "constant":
                    w_tot[~valid] = np.polyval(poly, lg_e_min)
                elif self.extrapolation_type == "linear":
                    w_tot[~valid] = np.polyval(lin, lg_e[~valid])
                else:
                    raise ValueError(f"unknown extrapolation type"
                                     f" {self.extrapolation_type!r}")
            container["dis_correction_total"] = ((w_tot - 1) * dis).astype(
                FTYPE)

            wf = splines[(current, 1 if nubar > 0 else -1)]
            w_diff = np.ones_like(lg_e)
            if valid.any():
                w_diff[valid] = wf.ev(lg_e[valid], bjorken_y[valid])
            if (~valid).any():
                w_diff[~valid] = wf.ev(np.full((~valid).sum(), lg_e_min),
                                       bjorken_y[~valid])
            container["dis_correction_diff"] = ((w_diff - 1) * dis).astype(
                FTYPE)

    def apply_function(self):
        if self.combine_components:
            tot = in_data_type(self.params.dis_csms.m_as("dimensionless"))
            diff = tot
        else:
            tot = in_data_type(self.params.dis_csms_tot.m_as("dimensionless"))
            diff = in_data_type(
                self.params.dis_csms_diff.m_as("dimensionless"))
        for container in self.data:
            factor = (1.0 + container["dis_correction_total"] * tot) * (
                1.0 + container["dis_correction_diff"] * diff)
            container["weights"] = container["weights"] * torch.clamp(
                factor, min=0.0)


def init_test(**param_kwargs):
    """Instantiation example."""
    param_set = ParamSet([Param(name="dis_csms", value=0.0, **param_kwargs)])
    return dis_sys(params=param_set)
