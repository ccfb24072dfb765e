"""
Two-flavour vacuum oscillation approximation (counterpart of
``pisa_tpu/stages/osc/two_nu_osc.py``; reference
``pisa/stages/osc/two_nu_osc.py``): P(numu -> nutau) = sin^2(2 theta23)
sin^2(1.267 dm31 L / E) with the production-height path length, applied as
torch elementwise ops per container. `theta23` is the amplitude
sin^2(2 theta23) given as a dimensionless magnitude, as in the reference.
In an evaluation of lanes the weights gain a leading lane axis.
"""

from __future__ import annotations

import torch

from pisa_tpu_torch import ureg
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type

__all__ = ["two_nu_osc", "calc_probs", "init_test"]

L1_KM = 19.0  # atmospheric production height
R_KM = 6378.2 + L1_KM  # mean Earth radius + L1


def calc_probs(t23, dm31, true_energy, true_coszen):
    """numu -> nutau transition probability (reference
    ``two_nu_osc.py:calc_probs``; `t23` is sin^2(2 theta23))."""
    zenith = torch.arccos(true_coszen)
    phi = torch.arcsin((1 - L1_KM / R_KM) * torch.sin(zenith))
    psi = zenith - phi
    propdist = torch.sqrt(
        (R_KM - L1_KM) ** 2
        + R_KM**2
        - 2 * (R_KM - L1_KM) * R_KM * torch.cos(psi)
    )
    return t23 * torch.sin(1.267 * dm31 * propdist / true_energy) ** 2


class two_nu_osc(Stage):  # noqa: N801
    """Params: theta23 (dimensionless amplitude), deltam31 (eV^2)."""

    def __init__(self, **std_kwargs):
        super().__init__(
            expected_params=("theta23", "deltam31"),
            expected_container_keys=(
                "true_energy", "true_coszen", "nu_flux", "weights",
            ),
            **std_kwargs,
        )

    def apply_function(self):
        theta = in_data_type(self.params.theta23.value.m_as("dimensionless"))
        dm31 = in_data_type(self.params.deltam31.value.m_as("eV**2"))

        for container in self.data:
            flux = container["nu_flux"]
            e = container["true_energy"]
            cz = container["true_coszen"]
            if "numu" in container.name:
                p = 1.0 - calc_probs(theta, dm31, e, cz)
                container["weights"] = container["weights"] * flux[..., 1] * p
            elif "nutau" in container.name:
                p = calc_probs(theta, dm31, e, cz)
                container["weights"] = container["weights"] * flux[..., 1] * p
            else:  # nue: unoscillated
                container["weights"] = container["weights"] * flux[..., 0]


def init_test(**param_kwargs):
    """Instantiation example."""
    param_kwargs.pop("range", None)
    param_set = ParamSet(
        [
            Param(
                name="theta23", value=0.95,
                range=[0, 1] * ureg.dimensionless, **param_kwargs,
            ),
            Param(
                name="deltam31", value=2.5e-3 * ureg.eV**2,
                range=[1e-3, 7e-3] * ureg.eV**2, **param_kwargs,
            ),
        ]
    )
    return two_nu_osc(params=param_set)
