"""
Environmentally induced decoherence (counterpart of
``pisa_tpu/stages/osc/decoherence.py``; reference
``pisa/stages/osc/decoherence.py``; arXiv:1702.04738): vacuum numu
disappearance with the interference terms damped exponentially, in the
2-flavour approximation (eq. 2) or the 3-flavour one (the unnumbered
equation between eqs. 2 and 3).

Torch elementwise ops, differentiable in the oscillation and decoherence
(gamma) parameters. Matter effects are not implemented, as in the
reference, which requires ``earth_model = None``. In an evaluation of lanes
the parameters come as (B, 1) tensors and the probabilities gain the lane
axis.
"""

from __future__ import annotations

import math

import torch

from pisa_tpu_torch import FTYPE, ureg
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type
from pisa_tpu_torch.ops.osc.layers import Layers
from pisa_tpu_torch.stages.osc.nusquids import ALL_FLAVS

__all__ = ["decoherence", "init_test", "numu_disappearance_2flav",
           "numu_disappearance_3flav", "KM_TO_INV_EV"]

KM_TO_INV_EV = 5.07e18 * 1e-9  # km -> 1/eV (hbar c); the reference's 5.07e18/GeV


def _sin(x):
    return torch.sin(x) if isinstance(x, torch.Tensor) else math.sin(x)


def _cos(x):
    return torch.cos(x) if isinstance(x, torch.Tensor) else math.cos(x)


def numu_disappearance_2flav(E, L, theta23, dm32, gamma32_eV):
    """Eq. 2 of arXiv:1702.04738 (reference
    ``_calc_numu_disappearance_prob_2flav``). E [GeV], L [km], gamma32
    [eV]."""
    norm = 0.5 * _sin(2.0 * theta23) ** 2
    decoh = torch.exp(-gamma32_eV * (L * 1e3 / 1.97e-7))
    osc = torch.cos(2.0 * 1.27 * dm32 * L / E)
    return norm * (1.0 - decoh * osc)


def numu_disappearance_3flav(E, L, theta12, theta13, theta23, dm21, dm31,
                             gammas_GeV):
    """3-flavour vacuum decoherence numu disappearance (reference
    ``_calc_numu_disappearance_prob_3flav``). gammas = (g21, g31, g32) in
    GeV."""
    c12, s12 = _cos(theta12), _sin(theta12)
    c13, s13 = _cos(theta13), _sin(theta13)
    c23, s23 = _cos(theta23), _sin(theta23)
    # |U_mu,j|^2 (real PMNS, delta_cp = 0 as in the reference)
    u2 = [
        (-s12 * c23 - c12 * s23 * s13) ** 2,
        (c12 * c23 - s12 * s23 * s13) ** 2,
        (s23 * c13) ** 2,
    ]
    dm32 = dm31 - dm21
    pairs = [
        (1, 0, gammas_GeV[0], dm21),
        (2, 0, gammas_GeV[1], dm31),
        (2, 1, gammas_GeV[2], dm32),
    ]
    prob = 0.0
    l_nat = L * 5.07e18  # km -> 1/GeV
    for j, k, gamma, dm in pairs:
        prob = prob + u2[j] * u2[k] * (
            1.0 - torch.exp(-gamma * l_nat)
            * torch.cos(dm * 1.0e-18 / (2.0 * E) * l_nat))
    return 2.0 * prob


class decoherence(Stage):  # noqa: N801
    """Params: the standard oscillation params and gamma21, gamma31,
    gamma32."""

    host_param_names = (
        "earth_model", "detector_depth", "prop_height", "YeI", "YeO", "YeM",
    )

    def __init__(self, two_flavor=False, **std_kwargs):
        super().__init__(
            expected_params=(
                "detector_depth", "earth_model", "prop_height",
                "YeI", "YeO", "YeM",
                "theta12", "theta13", "theta23",
                "deltam21", "deltam31", "deltacp",
                "gamma21", "gamma31", "gamma32",
            ),
            expected_container_keys=(
                "true_energy", "true_coszen", "weights", "nubar", "flav",
                "nu_flux",
            ),
            **std_kwargs,
        )
        if self.params.earth_model.value is not None:
            raise ValueError(
                "Matter effects not implemented for decoherence; set"
                " 'earth_model' to None"
            )
        self.two_flavor = two_flavor
        self.layers = None

    def setup_function(self):
        self.layers = Layers(None, self.params.detector_depth.m_as("km"),
                             self.params.prop_height.m_as("km"))
        if self.is_map:
            self.data.link_containers("nu", ALL_FLAVS)
        for container in self.data:
            self.layers.calcPathLength(
                container["true_coszen"].detach().cpu().numpy())
            container["distances"] = self.layers.distance.astype(FTYPE)
        self.data.unlink_containers()

    def compute_function(self):
        p = self.params
        theta12, theta13, theta23 = (in_data_type(p[n].m_as("rad"))
                                     for n in ("theta12", "theta13",
                                               "theta23"))
        dm21 = in_data_type(p.deltam21.m_as("eV**2"))
        dm31 = in_data_type(p.deltam31.m_as("eV**2"))
        gammas_GeV = tuple(in_data_type(p[n].m_as("GeV"))
                           for n in ("gamma21", "gamma31", "gamma32"))
        gamma32_eV = in_data_type(p.gamma32.m_as("eV"))
        for container in self.data:
            E = container["true_energy"]
            L = container["distances"]
            flav = int(container["flav"])
            if flav == 0:
                # nue: oscillations neglected in this approximation
                prob_e = torch.ones_like(E)
                prob_mu = torch.zeros_like(E)
            else:
                if self.two_flavor:
                    p_dis = numu_disappearance_2flav(
                        E, L, theta23, dm31 - dm21, gamma32_eV)
                else:
                    p_dis = numu_disappearance_3flav(
                        E, L, theta12, theta13, theta23, dm21, dm31,
                        gammas_GeV)
                prob_e = torch.zeros_like(p_dis)
                # numu: survival; nutau: appearance (no nue mixing)
                prob_mu = 1.0 - p_dis if flav == 1 else p_dis
            container["prob_e"] = prob_e
            container["prob_mu"] = prob_mu

    def apply_function(self):
        for container in self.data:
            flux = container["nu_flux"]
            container["weights"] = container["weights"] * (
                flux[..., 0] * container["prob_e"]
                + flux[..., 1] * container["prob_mu"]
            )


def init_test(**param_kwargs):
    """Instantiation example."""
    param_kwargs.pop("range", None)
    param_set = ParamSet(
        [
            Param(name="detector_depth", value=2 * ureg.km, **param_kwargs),
            Param(name="prop_height", value=20 * ureg.km, **param_kwargs),
            Param(name="earth_model", value=None, **param_kwargs),
            Param(name="YeI", value=0.4656, **param_kwargs),
            Param(name="YeO", value=0.4656, **param_kwargs),
            Param(name="YeM", value=0.4957, **param_kwargs),
            Param(name="theta12", value=33.48 * ureg.degree, **param_kwargs),
            Param(name="theta13", value=8.5 * ureg.degree, **param_kwargs),
            Param(name="theta23", value=42.3 * ureg.degree, **param_kwargs),
            Param(name="deltam21", value=7.5e-5 * ureg.eV**2, **param_kwargs),
            Param(name="deltam31", value=2.457e-3 * ureg.eV**2,
                  **param_kwargs),
            Param(name="deltacp", value=0 * ureg.degree, **param_kwargs),
            Param(name="gamma21", value=0.0 * ureg.eV, **param_kwargs),
            Param(name="gamma31", value=0.0 * ureg.eV, **param_kwargs),
            Param(name="gamma32", value=0.0 * ureg.eV, **param_kwargs),
        ]
    )
    return decoherence(params=param_set)
