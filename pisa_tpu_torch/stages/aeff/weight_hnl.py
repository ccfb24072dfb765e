"""
Heavy-neutral-lepton re-weighting (counterpart of
``pisa_tpu/stages/aeff/weight_hnl.py``; reference
``pisa/stages/aeff/weight_hnl.py``): re-weights HNL decays from the 1/L
sampling distribution to the physical exponential decay law, with the
U_tau4^2 mixing at production, in torch ops (differentiable in U_tau4_sq).
"""

from __future__ import annotations

import torch

from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type

__all__ = ["weight_hnl", "re_weight_hnl", "init_test"]

LIGHTSPEED = 299792458.0  # m/s
REDUCEDPLANCK = 6.582119569e-25  # GeV s


def re_weight_hnl(u_tau4_sq, mass, energy, tau_ns, distance_min,
                  distance_max, hnl_decay_width, c=LIGHTSPEED,
                  hbar=REDUCEDPLANCK):
    """Weight from 1/L-sampled decay lengths to the exponential decay law
    (reference ``weight_hnl.py:re_weight_hnl``). Units: mass and energy GeV,
    tau ns, distances m, decay width GeV."""
    gamma = torch.sqrt(energy**2 + mass**2) / mass
    speed = c * torch.sqrt(1.0 - 1.0 / gamma**2)
    tau_min = distance_min / (gamma * speed)
    tau_max = distance_max / (gamma * speed)
    tau_s = tau_ns * 1e-9

    tau_proper = hbar / (hnl_decay_width * u_tau4_sq)
    pdf_inverse = (1.0 / (torch.log(tau_max) - torch.log(tau_min))) * (
        1.0 / tau_s)
    pdf_exp = (1.0 / tau_proper) * torch.exp(-tau_s / tau_proper)
    return u_tau4_sq * pdf_exp / pdf_inverse


class weight_hnl(Stage):  # noqa: N801
    """Params: U_tau4_sq."""

    def __init__(self, **std_kwargs):
        super().__init__(
            expected_params=("U_tau4_sq",),
            expected_container_keys=(
                "mHNL", "hnl_true_energy", "hnl_proper_lifetime",
                "hnl_distance_min", "hnl_distance_max", "hnl_decay_width",
                "weights",
            ),
            **std_kwargs,
        )

    def apply_function(self):
        u_tau4_sq = in_data_type(self.params.U_tau4_sq.m_as("dimensionless"))
        for container in self.data:
            w = re_weight_hnl(
                u_tau4_sq,
                container["mHNL"],
                container["hnl_true_energy"],
                container["hnl_proper_lifetime"],
                container["hnl_distance_min"],
                container["hnl_distance_max"],
                container["hnl_decay_width"],
            )
            container["weights"] = container["weights"] * w


def init_test(**param_kwargs):
    """Instantiation example."""
    param_set = ParamSet([Param(name="U_tau4_sq", value=1e-2, **param_kwargs)])
    return weight_hnl(params=param_set)
