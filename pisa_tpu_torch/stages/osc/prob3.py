"""
Three-flavour matter-oscillation service (counterpart of
``pisa_tpu/stages/osc/prob3.py``; reference ``pisa/stages/osc/prob3.py:37``):
computes P(nu_e -> flav) and P(nu_mu -> flav) per grid point through
Earth-layer chains and applies ``weights *= flux_e * P_e + flux_mu * P_mu``.

Only the standard three-flavour path on a binned calc grid is ported: the
kernel geometry (chain-length sort, per-point bounds, layer-major slabs) is
prepared once at setup, and each compute makes two launches of the CUDA
chain kernel, one per nubar sign, through ``ops/osc/chain.py:osc_probs``.
That function is differentiable in the six oscillation parameters: when a
compiled template takes the gradient, its backward runs the multitangent
kernel once per sign (the flagship frees theta13, theta23 and deltam31: 3
tangents a launch), or, with ``multitangent=False``, the tangent kernel
once per free oscillation parameter and sign (6 launches); the
multitangent route takes less device time on the card (``PERF.md``). NSI, neutrino decay, LRI, Earth
tomography, layer dedup and per-event calc mode are not ported yet (ROADMAP
queue 1, item 11).
"""

from __future__ import annotations

import torch

from pisa_tpu_torch import TORCH_FTYPE, ureg
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.ops.osc.chain import osc_probs, prepare_chain_geometry
from pisa_tpu_torch.ops.osc.layers import Layers

__all__ = ["prob3"]

_ALL_FLAVS = [
    "nue_cc", "numu_cc", "nutau_cc", "nue_nc", "numu_nc", "nutau_nc",
    "nuebar_cc", "numubar_cc", "nutaubar_cc", "nuebar_nc", "numubar_nc",
    "nutaubar_nc",
]
_NU_FLAVS = _ALL_FLAVS[:6]
_NUBAR_FLAVS = _ALL_FLAVS[6:]

_NOT_PORTED = "is not ported yet (ROADMAP queue 1, item 11)"


class prob3(Stage):  # noqa: N801
    """See module docstring; parameters as in the reference
    (``prob3.py:124-161``), plus `multitangent` (the gradient's tangents in
    one multitangent launch per sign, the default, or in one tangent launch
    per free oscillation parameter and sign; settable on the instance)."""

    # the Earth model and electron fractions shape the layer geometry, which
    # is prepared on the host
    host_param_names = (
        "earth_model", "detector_depth", "prop_height", "YeI", "YeO", "YeM",
    )
    _THETA_NAMES = (
        "theta12", "theta13", "theta23", "deltacp", "deltam21", "deltam31",
    )
    _THETA_UNITS = ("rad", "rad", "rad", "rad", "eV**2", "eV**2")

    def __init__(
        self,
        include_nlo=False,
        nsi_type=None,
        reparam_mix_matrix=False,
        neutrino_decay=False,
        tomography_type=None,
        lri_type=None,
        layer_dedup=False,
        multitangent=True,
        **std_kwargs,
    ):
        for option, value in (
            ("nsi_type", nsi_type),
            ("neutrino_decay", neutrino_decay),
            ("tomography_type", tomography_type),
            ("lri_type", lri_type),
            ("layer_dedup", layer_dedup),
        ):
            if value:
                raise NotImplementedError(f"prob3 {option}={value!r} {_NOT_PORTED}")
        self.include_nlo = include_nlo
        self.reparam_mix_matrix = reparam_mix_matrix
        self.multitangent = bool(multitangent)
        super().__init__(
            expected_params=(
                "detector_depth", "earth_model", "prop_height", "YeI", "YeO",
                "YeM", "theta12", "theta13", "theta23", "deltam21",
                "deltam31", "deltacp",
            ),
            expected_container_keys=(
                "true_energy", "true_coszen", "nubar", "flav", "nu_flux",
                "weights",
            ),
            **std_kwargs,
        )
        if not self.is_map:
            raise NotImplementedError(
                f"prob3 calc_mode={self.calc_mode!r} (per-event) {_NOT_PORTED}"
            )
        self.layers = None
        self.geom = None
        self.YeI = self.YeO = self.YeM = None

    # -- setup ---------------------------------------------------------------
    def setup_function(self):
        self.YeI = self.params.YeI.m_as("dimensionless")
        self.YeO = self.params.YeO.m_as("dimensionless")
        self.YeM = self.params.YeM.m_as("dimensionless")
        self.layers = Layers(
            self.params.earth_model.value,
            self.params.detector_depth.m_as("km"),
            self.params.prop_height.m_as("km"),
        )
        self.layers.setElecFrac(self.YeI, self.YeO, self.YeM)
        self._prepare_geometry()

    def _prepare_geometry(self):
        """Layer chains of the calc grid (flavour-independent, so computed
        once for all categories) and the kernel's prepared geometry."""
        binning = self.calc_mode
        grid = binning.meshgrid(entity="weighted_centers", attach_units=False)
        energy = grid[binning.index("true_energy")].ravel()
        coszen = grid[binning.index("true_coszen")].ravel()
        self.layers.calcLayers(coszen)
        shape = (energy.size, self.layers.max_layers)
        self.geom = prepare_chain_geometry(
            energy,
            self.layers.density.reshape(shape),
            self.layers.distance.reshape(shape),
            dtype=TORCH_FTYPE,
            device=self.data.device,
        )

    # -- compute --------------------------------------------------------------
    def compute_function(self):
        # re-derive the layers if the electron fractions changed
        ye = tuple(
            self.params[n].m_as("dimensionless") for n in ("YeI", "YeO", "YeM")
        )
        if ye != (self.YeI, self.YeO, self.YeM):
            self.YeI, self.YeO, self.YeM = ye
            self.layers.setElecFrac(*ye)
            self._prepare_geometry()

        # angles must carry units (reference prob3.py:480-482)
        for angle in (
            self.params.theta12,
            self.params.theta13,
            self.params.theta23,
            self.params.deltacp,
        ):
            if angle.value.units == ureg.dimensionless:
                raise ValueError(f"{angle.name} is dimensionless; give rad or deg")
        # the parameter magnitudes may be 0-d tensors that carry the autograd
        # graph (compiled template): stacked, not converted
        prms = [self.params[name] for name in self._THETA_NAMES]
        theta = torch.stack([
            torch.as_tensor(p.m_as(u), dtype=torch.float64)
            for p, u in zip(prms, self._THETA_UNITS)
        ])
        # tangents only for the free oscillation parameters (prob3.py:604-617
        # of the JAX package); the flagship frees 3 of the 6
        active = tuple(i for i, p in enumerate(prms) if not p.is_fixed)
        nlo_factor = 1.020 if self.include_nlo else 1.0

        self.data.link_containers("nu", _NU_FLAVS)
        self.data.link_containers("nubar", _NUBAR_FLAVS)
        for container in self.data:
            container["probability"] = osc_probs(
                theta, int(container["nubar"]), self.geom,
                reparam=self.reparam_mix_matrix, nlo_factor=nlo_factor,
                active=active, multitangent=self.multitangent,
            )
        self.data.unlink_containers()

        # per-flavour projections: P(e -> flav), P(mu -> flav)
        for container in self.data:
            flav = int(container["flav"])
            probs = container["probability"]
            container["prob_e"] = probs[:, 0, flav]
            container["prob_mu"] = probs[:, 1, flav]

    def apply_function(self):
        calc_h = hash(self.calc_mode)
        for container in self.data:
            # When flux and probabilities are valid on the calc grid and the
            # apply representation is events, form the rate on the grid and
            # translate the one channel: the 'average' lookup gathers the
            # event's own grid cell, so gather(flux)*gather(prob) ==
            # gather(flux*prob) exactly. Not so for a binned apply (resample
            # averages) or an already per-event flux: the unfused branch.
            apply_rep = container.representation
            apply_h = hash(apply_rep)
            valid = container.validity
            fusable = (
                apply_h != calc_h
                and isinstance(apply_rep, str)
                and not valid.get("nu_flux", {}).get(apply_h, False)
                and valid.get("nu_flux", {}).get(calc_h, False)
                and valid.get("prob_e", {}).get(calc_h, False)
                and valid.get("prob_mu", {}).get(calc_h, False)
            )
            if fusable:
                container.representation = self.calc_mode
                nu_flux = container["nu_flux"]
                container["osc_flux_rate"] = (
                    nu_flux[:, 0] * container["prob_e"]
                    + nu_flux[:, 1] * container["prob_mu"]
                )
                container.representation = apply_rep
                container["weights"] = (
                    container["weights"] * container["osc_flux_rate"]
                )
            else:
                nu_flux = container["nu_flux"]
                container["weights"] = container["weights"] * (
                    nu_flux[:, 0] * container["prob_e"]
                    + nu_flux[:, 1] * container["prob_mu"]
                )
