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
multitangent route takes less device time on the card (``PERF.md``).

On a category-stacked container (``core/stacking.py``) the compute is the
same two launches; the probabilities become 6 rows (nubar group x final
flavour) that a rows map spreads over the categories, and the apply forms
one (6, ngrid) flux x probability rate on the grid. That rate is gathered to
the stacked events in one op, or, when the template that owns the container
set up rate deferral (``container.rate_defer``), handed to the histogram
stage as a grid-level factor (``container.deferred_rate``).

In an evaluation of lanes (``container.lanes``, the batched fits) theta is a
(B, 6) tensor and every output gains a leading lane axis; the launches stay
two per sign-pair, each serving all lanes.

NSI, neutrino decay, LRI, Earth tomography, layer dedup and per-event calc
mode (with it the JAX package's stacked events-calc route, which needs the
XLA formulation ``ops/osc/kernels.py``) are not ported yet (ROADMAP queue 1,
items 2 and 11).
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch import TORCH_FTYPE, ureg
from pisa_tpu_torch.core.binning import MultiDimBinning
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.ops.osc.chain import (
    osc_probs,
    prepare_chain_geometry,
    theta_tensor,
)
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
        # the parameter magnitudes may be 0-d tensors on the device that
        # carry the autograd graph (compiled template): stacked, not
        # converted; the numbers among them are filled in on the device
        prms = [self.params[name] for name in self._THETA_NAMES]
        lanes = self.data.lanes
        theta = theta_tensor(
            [p.m_as(u) for p, u in zip(prms, self._THETA_UNITS)],
            device=self.data.device, lanes=lanes,
        )  # (6,), or (B, 6) lanes
        # tangents only for the free oscillation parameters (prob3.py:604-617
        # of the JAX package); the flagship frees 3 of the 6
        active = tuple(i for i, p in enumerate(prms) if not p.is_fixed)
        nlo_factor = 1.020 if self.include_nlo else 1.0

        if any(getattr(c, "is_stacked", False) for c in self.data.containers):
            # one propagation per nubar sign, as on the linked path, stacked
            # into 2 rows; the per-flavour projections become 6 rows (nubar
            # group x final flavour) that a rows map spreads over the
            # categories
            for container in self.data:
                grp = (np.asarray(container.cat_aux("nubar")) < 0).astype(
                    np.int32)
                flav = np.asarray(container.cat_aux("flav"), dtype=np.int32)
                probability = torch.stack([
                    osc_probs(
                        theta, sign, self.geom,
                        reparam=self.reparam_mix_matrix,
                        nlo_factor=nlo_factor, active=active,
                        multitangent=self.multitangent,
                    )
                    for sign in (1, -1)
                ], dim=-4)  # ([B,] 2, n, 3, 3)
                container.set_stacked("probability", probability, rows=grp)
                # rows = group * 3 + final flavour: P(e -> f), P(mu -> f)
                lead = probability.shape[:-4]
                pe = probability[..., 0, :].transpose(-1, -2).reshape(
                    lead + (6, -1))
                pm = probability[..., 1, :].transpose(-1, -2).reshape(
                    lead + (6, -1))
                container.set_stacked("prob_e", pe, rows=grp * 3 + flav)
                container.set_stacked("prob_mu", pm, rows=grp * 3 + flav)
            return

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
            container["prob_e"] = probs[..., 0, flav]
            container["prob_mu"] = probs[..., 1, flav]

    def stacked_ok(self):
        return not isinstance(self.apply_mode, MultiDimBinning)

    def _apply_stacked(self, container):
        """The (6, ngrid) rate (nubar group x final flavour; the flux does
        not depend on the flavour, so each of its 2 rows serves 3 rate
        rows) formed on the grid, then gathered to the stacked events in one
        op or deferred to the histogram stage. With a per-event flux the
        grid identity does not hold: the probabilities are gathered and the
        product taken per event, as on the unstacked unfused branch."""
        rep = container.representation
        calc_h = hash(self.calc_mode)
        k = 0 if container.lanes is None else 1  # the lane axis, if any
        if isinstance(rep, str) and container.validity.get(
                "nu_flux", {}).get(hash(rep), False):
            nu_flux = container["nu_flux"]  # (C, n_pad, 2) per event
            container["weights"] = container["weights"] * (
                nu_flux[..., 0] * container["prob_e"]
                + nu_flux[..., 1] * container["prob_mu"]
            )
            return
        container.representation = self.calc_mode
        nu_flux = container["nu_flux"]  # (2, n, 2), rows = nubar group
        rows_flux = container.rows[("nu_flux", calc_h)]
        pe = container["prob_e"]  # (6, n), rows = group * 3 + flavour
        pm = container["prob_mu"]
        rows_pf = container.rows[("prob_e", calc_h)]
        if nu_flux.dim() - k == 2:
            nf6 = nu_flux.unsqueeze(k)  # one flux shared by all categories
        elif (
            nu_flux.shape[k] == 2
            and isinstance(rows_flux, np.ndarray)
            and np.array_equal(rows_flux, np.asarray(rows_pf) // 3)
        ):
            # each flux group row for its 3 flavour rows
            nf6 = nu_flux.repeat_interleave(3, dim=k)
        else:
            raise NotImplementedError(
                "stacked prob3 expects a shared or nubar-grouped nu_flux on"
                f" the calc grid (got shape {tuple(nu_flux.shape)}, rows"
                f" {rows_flux!r})"
            )
        rate = nf6[..., 0] * pe + nf6[..., 1] * pm
        if container.rate_defer is not None:
            # the histogram stage contracts the grid rate with its static
            # (grid x bins) matrices (stages/utils/hist.py)
            container.deferred_rate = {"rate": rate, "rows": rows_pf}
            container.representation = rep
            return
        container.set_stacked("osc_flux_rate", rate, rows=rows_pf)
        container.representation = rep
        container["weights"] = (
            container["weights"] * container["osc_flux_rate"]
        )

    def apply_function(self):
        calc_h = hash(self.calc_mode)
        for container in self.data:
            if getattr(container, "is_stacked", False):
                self._apply_stacked(container)
                continue
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
                    nu_flux[..., 0] * container["prob_e"]
                    + nu_flux[..., 1] * container["prob_mu"]
                )
                container.representation = apply_rep
                container["weights"] = (
                    container["weights"] * container["osc_flux_rate"]
                )
            else:
                nu_flux = container["nu_flux"]
                container["weights"] = container["weights"] * (
                    nu_flux[..., 0] * container["prob_e"]
                    + nu_flux[..., 1] * container["prob_mu"]
                )
