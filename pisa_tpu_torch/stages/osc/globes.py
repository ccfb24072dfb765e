"""
3+1 sterile-neutrino oscillation service with the GLoBES wrapper's
parameter vocabulary and weight conventions (counterpart of
``pisa_tpu/stages/osc/globes.py``; reference
``pisa/stages/osc/globes.py:33-291``).

The reference loops GLoBES's ``MatterProbabilityPrevBaseline`` per event;
the JAX package and this port propagate each (nu, nubar) link in one batch
through the 3+1 engine (``ops/osc/sterile.py``, on a card with the
hand-written eigenvalue kernel), differentiable in every mixing parameter.

The reference's weight conventions (``globes.py:155-172,245-291``):

- charged-current events: ``prob_e = P(nue -> flav)``, ``prob_mu =
  P(numu -> flav)`` including sterile effects, ``prob_nonsterile = 1``;
- neutral-current events: ``prob_nonsterile = sum_x P(flav -> x)`` over the
  three active flavours (the sterile-depletion survival factor), while
  ``prob_e``/``prob_mu`` are the flavour-identity indicators fixed at set-up;
- ``weights *= (flux_e prob_e + flux_mu prob_mu) prob_nonsterile``.

The mixing is the reference's ``SetParametersArr`` (``globes.py:219-232``):
theta14 and both sterile CP phases pinned to zero, so only theta24, theta34
and deltam41 extend the 3-flavour sector. As in the JAX package, the
electron fractions are the framework's explicit ``YeI/YeO/YeM`` (the
reference lets GLoBES pick them by a density threshold). In an evaluation
of lanes the probabilities gain a leading lane axis; the fixed slots stay
as set up and broadcast. The stage does not run stacked.
"""

from __future__ import annotations

import numpy as np

from pisa_tpu_torch import FTYPE, TORCH_FTYPE, ureg
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.ops.osc.chain import theta_tensor
from pisa_tpu_torch.ops.osc.layers import Layers
from pisa_tpu_torch.ops.osc.sterile import (
    pmns4_matrix,
    prepare_4nu_geometry,
    propagate_4nu,
)
from pisa_tpu_torch.stages.osc.nusquids import (
    ALL_FLAVS,
    check_angle_units,
    grid_points,
)
from pisa_tpu_torch.utils.log import logging

__all__ = ["globes", "init_test"]

_NU_FLAVS = ALL_FLAVS[:6]
_NUBAR_FLAVS = ALL_FLAVS[6:]


def _km(x):
    return x.m_as("km") if hasattr(x, "m_as") else float(x)


class globes(Stage):  # noqa: N801
    """See module docstring; reference parameters at
    ``globes.py:36-66,297-312``.

    Parameters
    ----------
    earth_model : PREM file path (resource-resolved)
    globes_wrapper : ignored (the reference needs the external wrapper
        checkout path; the native engine needs nothing)
    detector_depth, prop_height : quantities (km)
    YeI, YeO, YeM : electron fractions (see module docstring)
    """

    def __init__(
        self,
        earth_model,
        globes_wrapper=None,
        detector_depth=2.0 * ureg.km,
        prop_height=20.0 * ureg.km,
        YeI=0.4656,
        YeO=0.4656,
        YeM=0.4957,
        **std_kwargs,
    ):
        if globes_wrapper is not None:
            logging.info(
                "osc.globes: 'globes_wrapper' (%r) is the external GLoBES"
                " checkout path needed by the reference wrapper; the native"
                " engine ignores it", globes_wrapper,
            )
        self.earth_model = earth_model
        self.detector_depth = detector_depth
        self.prop_height = prop_height
        self.YeI = float(YeI)
        self.YeO = float(YeO)
        self.YeM = float(YeM)
        super().__init__(
            expected_params=(
                "theta12", "theta13", "theta23", "deltam21", "deltam31",
                "deltam41", "theta24", "theta34", "deltacp",
            ),
            expected_container_keys=(
                "true_energy", "true_coszen", "nubar", "flav", "nu_flux",
                "weights",
            ),
            **std_kwargs,
        )
        self.geom = None
        self.geoms = {}

    def _geometry(self, energy, coszen):
        self.layers.calcLayers(np.asarray(coszen, dtype=np.float64))
        shape = (len(coszen), self.layers.max_layers)
        return prepare_4nu_geometry(
            energy, self.layers.density.reshape(shape),
            self.layers.density_neutron_weighted.reshape(shape),
            self.layers.distance.reshape(shape), dtype=TORCH_FTYPE,
            device=self.data.device)

    def setup_function(self):
        self.layers = Layers(self.earth_model, _km(self.detector_depth),
                             _km(self.prop_height))
        self.layers.setElecFrac(self.YeI, self.YeO, self.YeM)
        self.geoms = {}
        if self.is_map:
            self.geom = self._geometry(*grid_points(self.calc_mode))
        else:
            for container in self.data:
                self.geoms[container.name] = self._geometry(
                    container["true_energy"].detach().cpu().numpy(),
                    container["true_coszen"].detach().cpu().numpy())

        # the fixed probability slots (globes.py:155-172): CC events always
        # have prob_nonsterile = 1, NC events the flavour-identity prob_e,
        # prob_mu
        for container in self.data:
            flav = int(container["flav"])
            if container.name.endswith("_cc"):
                container["prob_e"] = np.empty(container.size, dtype=FTYPE)
                container["prob_mu"] = np.empty(container.size, dtype=FTYPE)
                container["prob_nonsterile"] = np.ones(container.size,
                                                       dtype=FTYPE)
            elif container.name.endswith("_nc"):
                container["prob_e"] = np.full(
                    container.size, 1.0 if flav == 0 else 0.0, dtype=FTYPE)
                container["prob_mu"] = np.full(
                    container.size, 1.0 if flav == 1 else 0.0, dtype=FTYPE)
                container["prob_nonsterile"] = np.empty(container.size,
                                                        dtype=FTYPE)
            else:
                raise ValueError(
                    f"unknown container name: {container.name!r} - osc.globes"
                    " requires *_cc / *_nc containers (reference"
                    " globes.py:160)")

    def compute_function(self):
        p = self.params
        check_angle_units([p.theta12, p.theta13, p.theta23, p.theta24,
                           p.theta34, p.deltacp])
        device, lanes = self.data.device, self.data.lanes
        # SetParametersArr (globes.py:219-232): theta14 and the sterile CP
        # phases pinned to zero
        mix = pmns4_matrix(
            p.theta12.m_as("rad"), p.theta13.m_as("rad"),
            p.theta23.m_as("rad"), 0.0, p.theta24.m_as("rad"),
            p.theta34.m_as("rad"), p.deltacp.m_as("rad"), 0.0, 0.0,
            device=device, lanes=lanes)
        dms = theta_tensor(
            [0.0] + [p[n].m_as("eV**2")
                     for n in ("deltam21", "deltam31", "deltam41")],
            device=device, lanes=lanes)
        if self.is_map:
            self.data.link_containers("nu", _NU_FLAVS)
            self.data.link_containers("nubar", _NUBAR_FLAVS)
        for container in self.data:
            geom = self.geom if self.is_map else self.geoms[container.name]
            container["probability4"] = propagate_4nu(
                dms, mix, int(container["nubar"]), geom)
        self.data.unlink_containers()
        for container in self.data:
            flav = int(container["flav"])
            probs4 = container["probability4"]
            if container.name.endswith("_cc"):
                # P(nue -> flav), P(numu -> flav), sterile effects included
                container["prob_e"] = probs4[..., 0, flav]
                container["prob_mu"] = probs4[..., 1, flav]
            else:
                # survival into any active flavour (globes.py:195-214)
                container["prob_nonsterile"] = probs4[..., flav, :3].sum(-1)

    def apply_function(self):
        for container in self.data:
            nu_flux = container["nu_flux"]
            container["weights"] = container["weights"] * (
                (nu_flux[..., 0] * container["prob_e"]
                 + nu_flux[..., 1] * container["prob_mu"])
                * container["prob_nonsterile"]
            )


def init_test(**param_kwargs):
    """Instantiation example (reference globes.py:297-312)."""
    param_set = ParamSet(
        [
            Param(name="theta12", value=33 * ureg.degree, **param_kwargs),
            Param(name="theta13", value=8 * ureg.degree, **param_kwargs),
            Param(name="theta23", value=50 * ureg.degree, **param_kwargs),
            Param(name="theta24", value=8 * ureg.degree, **param_kwargs),
            Param(name="theta34", value=0 * ureg.degree, **param_kwargs),
            Param(name="deltam21", value=8e-5 * ureg.eV**2, **param_kwargs),
            Param(name="deltam31", value=3e-3 * ureg.eV**2, **param_kwargs),
            Param(name="deltam41", value=1.0 * ureg.eV**2, **param_kwargs),
            Param(name="deltacp", value=180 * ureg.degree, **param_kwargs),
        ]
    )
    return globes(earth_model="osc/PREM_12layer.dat", params=param_set)
