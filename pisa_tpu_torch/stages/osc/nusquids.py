"""
3+1 / 3-flavour oscillation service with nuSQuIDS-compatible parameters
(counterpart of ``pisa_tpu/stages/osc/nusquids.py``; reference
``pisa/stages/osc/nusquids.py:36-140``).

The reference wraps the external nuSQuIDS engine; the JAX package computes
the same physics natively, and so does this port:

- ``num_neutrinos=4``: the 3+1 engine (``ops/osc/sterile.py:
  propagate_4nu``): deflated spectral-projector transitions of 4x4 complex
  Hamiltonians, the CC potential on nu_e and the NC potential on the sterile
  state through neutron-weighted layer densities, the eigenvalues from the
  hand-written CUDA kernel on a card (``csrc/herm4_eig.cu``);
  differentiable in every coupling, in both modes;
- ``num_neutrinos=3``: the general formulation that the JAX package calls
  here is the function the chain kernels compute at a general pack, so on a
  card this route is prob3's general-pack route (``ops/osc/chain.py:
  osc_probs_general`` over ``prepare_chain_geometry(..., general=True)``):
  the primal kernel forward, the general formulation's reverse mode
  backward, the tangent and multitangent kernels in forward mode;
- ``prop_lowpass_cutoff`` / ``prop_lowpass_frac``: the nuSQuIDS low-pass
  semantics, the 3+1 engine's density-matrix picture, which damps the
  interference of eigenstate pairs above the cutoff frequency so that
  eV^2-scale oscillations average instead of aliasing on a coarse grid;
- ``node_mode``: the calc_mode grid and the container translation are this
  framework's node grid and interpolation; a ``node_mode`` is accepted for
  config compatibility.

The parameter vocabulary is the reference's (theta12..theta34, deltam21/31/
41, deltacp, deltacp14, deltacp24, the Earth model and electron fractions),
and the external integrator's tuning options (``rel_err``, ``abs_err``,
...) are accepted, logged and ignored. The layer geometry is prepared once
at set-up, for the calc grid (binned calc mode: the chains do not depend on
the flavour) or per container (events). In an evaluation of lanes
(``container.lanes``) the parameters come as (B, 1) tensors, the mixing
matrices and splittings gain a leading lane axis and so does every output.
The stage does not run on a category-stacked container (the JAX stage does
not either): a compiled template runs it per container.
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch import TORCH_FTYPE, ureg
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.ops.osc.chain import (
    osc_probs_general,
    prepare_chain_geometry,
    theta_tensor,
)
from pisa_tpu_torch.ops.osc.layers import Layers
from pisa_tpu_torch.ops.osc.pmns import dm_matrix, pmns_matrix
from pisa_tpu_torch.ops.osc.sterile import (
    pmns4_matrix,
    prepare_4nu_geometry,
    propagate_4nu,
)
from pisa_tpu_torch.utils.log import logging

__all__ = ["nusquids", "init_test", "ALL_FLAVS", "check_angle_units",
           "grid_points"]

ALL_FLAVS = [
    "nue_cc", "numu_cc", "nutau_cc", "nue_nc", "numu_nc", "nutau_nc",
    "nuebar_cc", "numubar_cc", "nutaubar_cc", "nuebar_nc", "numubar_nc",
    "nutaubar_nc",
]
_NU_FLAVS = ALL_FLAVS[:6]
_NUBAR_FLAVS = ALL_FLAVS[6:]

#: accepted-but-inert engine-tuning options of the reference wrapper
_IGNORED_OPTIONS = (
    "rel_err", "abs_err", "suppress_interpolation_warning",
    "apply_lowpass_above_hor", "apply_height_avg_below_hor",
    "prop_height_range", "eval_lowpass_cutoff", "eval_lowpass_frac",
    "exact_mode", "use_taus",
)


def check_angle_units(params):
    """Angles must carry units (reference ``prob3.py:480-482``)."""
    for angle in params:
        if angle.value.units == ureg.dimensionless:
            raise ValueError(f"{angle.name} is dimensionless; give rad or deg")


def grid_points(binning):
    """(energy, coszen) of the weighted centres of a calc grid, flat."""
    grid = binning.meshgrid(entity="weighted_centers", attach_units=False)
    return (grid[binning.index("true_energy")].ravel(),
            grid[binning.index("true_coszen")].ravel())


class nusquids(Stage):  # noqa: N801
    """See module docstring; reference parameters at
    ``nusquids.py:161-173,321-331``."""

    host_param_names = (
        "earth_model", "detector_depth", "prop_height", "YeI", "YeO", "YeM",
    )

    def __init__(
        self,
        num_neutrinos=3,
        vacuum=False,
        node_mode=None,
        prop_lowpass_cutoff=None,
        prop_lowpass_frac=None,
        use_decoherence=False,
        use_nsi=False,
        **std_kwargs,
    ):
        self.num_neutrinos = int(num_neutrinos)
        if self.num_neutrinos not in (3, 4):
            raise ValueError(
                "This implementation is restricted to 3 or 4 neutrino"
                " flavors (as is the reference wrapper,"
                " nusquids.py:319-333)"
            )
        if use_decoherence:
            raise ValueError(
                "use_decoherence: use the native osc.decoherence service"
            )
        if use_nsi:
            raise ValueError("use_nsi: use osc.prob3 with nsi_type")
        self.vacuum = bool(vacuum)
        self.node_mode = node_mode

        def magnitude(v, units, default):
            if v is None:
                return default
            return float(v.m_as(units) if hasattr(v, "m_as") else v)

        # 1/km and dimensionless, as the reference's quantities; plain
        # numbers are taken in those units
        self.prop_lowpass_cutoff = magnitude(prop_lowpass_cutoff, "1/km", 0.0)
        self.prop_lowpass_frac = magnitude(prop_lowpass_frac, "dimensionless",
                                           0.1)
        for opt in _IGNORED_OPTIONS:
            if opt in std_kwargs:
                logging.info(
                    "osc.nusquids: option %r is engine tuning of the"
                    " external nuSQuIDS integrator and has no effect on"
                    " the native engine; ignored", opt,
                )
                std_kwargs.pop(opt)

        expected_params = [
            "earth_model", "detector_depth", "prop_height",
            "YeI", "YeO", "YeM",
            "theta12", "theta13", "theta23",
            "deltam21", "deltam31", "deltacp",
        ]
        if self.num_neutrinos == 4:
            expected_params += [
                "theta14", "theta24", "theta34",
                "deltam41", "deltacp14", "deltacp24",
            ]
        super().__init__(
            expected_params=tuple(expected_params),
            expected_container_keys=(
                "true_energy", "true_coszen", "nubar", "flav", "nu_flux",
                "weights",
            ),
            **std_kwargs,
        )
        #: the calc grid's geometry (binned calc mode), or per container
        #: name the events' (events calc mode)
        self.geom = None
        self.geoms = {}

    # -- setup ---------------------------------------------------------------
    def _geometry(self, energy, coszen):
        """The propagation's static inputs for these points."""
        self.layers.calcLayers(np.asarray(coszen, dtype=np.float64))
        shape = (len(coszen), self.layers.max_layers)
        distances = self.layers.distance.reshape(shape)
        densities = self.layers.density.reshape(shape)
        densities_n = self.layers.density_neutron_weighted.reshape(shape)
        if self.vacuum:
            densities = np.zeros(shape)
            densities_n = np.zeros(shape)
        device = self.data.device
        if self.num_neutrinos == 4:
            return prepare_4nu_geometry(energy, densities, densities_n,
                                        distances, dtype=TORCH_FTYPE,
                                        device=device)
        return prepare_chain_geometry(energy, densities, distances,
                                      dtype=TORCH_FTYPE, device=device,
                                      general=True)

    def setup_function(self):
        if self.node_mode is not None:
            logging.info(
                "osc.nusquids: node placement and interpolation are performed"
                " by the calc_mode grid and the container translation"
            )
        self.layers = Layers(
            self.params.earth_model.value,
            self.params.detector_depth.m_as("km"),
            self.params.prop_height.m_as("km"),
        )
        self.layers.setElecFrac(
            *(self.params[n].m_as("dimensionless")
              for n in ("YeI", "YeO", "YeM")))
        self.geoms = {}
        if self.is_map:
            self.geom = self._geometry(*grid_points(self.calc_mode))
            return
        for container in self.data:
            self.geoms[container.name] = self._geometry(
                container["true_energy"].detach().cpu().numpy(),
                container["true_coszen"].detach().cpu().numpy())

    # -- compute --------------------------------------------------------------
    def _physics(self):
        """The propagation's inputs from the params, on the data's device
        (float64; (B, ...) lanes in an evaluation of lanes)."""
        device, lanes = self.data.device, self.data.lanes
        p = self.params
        if self.num_neutrinos == 4:
            mix = pmns4_matrix(
                *(p[n].m_as("rad") for n in (
                    "theta12", "theta13", "theta23", "theta14", "theta24",
                    "theta34", "deltacp", "deltacp14", "deltacp24")),
                device=device, lanes=lanes)
            dms = theta_tensor(
                [0.0] + [p[n].m_as("eV**2")
                         for n in ("deltam21", "deltam31", "deltam41")],
                device=device, lanes=lanes)
            return {"dm": dms, "mix": mix}
        theta = theta_tensor(
            [p[n].m_as(u) for n, u in (
                ("theta12", "rad"), ("theta13", "rad"), ("theta23", "rad"),
                ("deltacp", "rad"), ("deltam21", "eV**2"),
                ("deltam31", "eV**2"))],
            device=device, lanes=lanes)
        t12, t13, t23, dcp, dm21, dm31 = theta.unbind(-1)
        mat_pot = torch.zeros((3, 3), dtype=torch.complex128, device=device)
        mat_pot[0, 0].fill_(1.0)
        return {
            "dm": dm_matrix(dm21, dm31),
            "mix": pmns_matrix(torch.sin(t12), torch.sin(t13),
                               torch.sin(t23), dcp),
            "mat_pot": mat_pot,
            "lri_pot": torch.zeros((3, 3), dtype=torch.float64, device=device),
        }

    def _propagate(self, geom, nubar, physics):
        """([B,] N, 3, 3) probabilities of one propagation (the 3+1 engine's
        active block for 4 flavours)."""
        if self.num_neutrinos == 4:
            probs4 = propagate_4nu(physics["dm"], physics["mix"], nubar, geom,
                                   lowpass_cutoff=self.prop_lowpass_cutoff,
                                   lowpass_frac=self.prop_lowpass_frac)
            return probs4[..., :3, :3]
        return osc_probs_general(physics["dm"], physics["mix"],
                                 physics["mat_pot"], physics["lri_pot"],
                                 nubar, geom)

    def compute_function(self):
        p = self.params
        check_angle_units([p.theta12, p.theta13, p.theta23, p.deltacp])
        physics = self._physics()
        if self.is_map:
            self.data.link_containers("nu", _NU_FLAVS)
            self.data.link_containers("nubar", _NUBAR_FLAVS)
        for container in self.data:
            geom = self.geom if self.is_map else self.geoms[container.name]
            container["probability"] = self._propagate(
                geom, int(container["nubar"]), physics)
        self.data.unlink_containers()
        for container in self.data:
            flav = int(container["flav"])
            probs = container["probability"]
            container["prob_e"] = probs[..., 0, flav]
            container["prob_mu"] = probs[..., 1, flav]

    def apply_function(self):
        for container in self.data:
            nu_flux = container["nu_flux"]
            container["weights"] = container["weights"] * (
                nu_flux[..., 0] * container["prob_e"]
                + nu_flux[..., 1] * container["prob_mu"]
            )


def init_test(**param_kwargs):
    """Instantiation example: a 3+1 sterile configuration."""
    param_set = ParamSet(
        [
            Param(name="earth_model", value="osc/PREM_12layer.dat",
                  **param_kwargs),
            Param(name="detector_depth", value=2 * ureg.km, **param_kwargs),
            Param(name="prop_height", value=20 * ureg.km, **param_kwargs),
            Param(name="YeI", value=0.4656, **param_kwargs),
            Param(name="YeO", value=0.4656, **param_kwargs),
            Param(name="YeM", value=0.4957, **param_kwargs),
            Param(name="theta12", value=33.4 * ureg.degree, **param_kwargs),
            Param(name="theta13", value=8.5 * ureg.degree, **param_kwargs),
            Param(name="theta23", value=42.3 * ureg.degree, **param_kwargs),
            Param(name="deltam21", value=7.42e-5 * ureg.eV**2,
                  **param_kwargs),
            Param(name="deltam31", value=2.514e-3 * ureg.eV**2,
                  **param_kwargs),
            Param(name="deltacp", value=0 * ureg.degree, **param_kwargs),
            Param(name="theta14", value=5 * ureg.degree, **param_kwargs),
            Param(name="theta24", value=8 * ureg.degree, **param_kwargs),
            Param(name="theta34", value=0 * ureg.degree, **param_kwargs),
            Param(name="deltam41", value=1.0 * ureg.eV**2, **param_kwargs),
            Param(name="deltacp14", value=0 * ureg.degree, **param_kwargs),
            Param(name="deltacp24", value=0 * ureg.degree, **param_kwargs),
        ]
    )
    return nusquids(num_neutrinos=4, params=param_set)
