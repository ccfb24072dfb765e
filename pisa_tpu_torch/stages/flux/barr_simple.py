"""
Barr-style flux-systematics stage (counterpart of
``pisa_tpu/stages/flux/barr_simple.py``; reference
``pisa/stages/flux/barr_simple.py``): applies the nue/numu ratio, nu/nubar
ratio, spectral-index tilt, and Barr up/hor + nu/nubar parameterized
modifications to the nominal (nue, numu) flux pair per point, as one set of
torch ops per (linked) container, or, on a category-stacked container
(``core/stacking.py``), as one chain from fields precomputed at set-up: in
grid calc mode it gives the (2, ngrid, 2) nu/nubar flux pair, in the
per-event calc mode the (C, n_pad, 2) flux of every stacked event, with each
category's nubar sign a (C, 1) select. In an evaluation of lanes every flux
gains a leading lane axis.
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type
from pisa_tpu_torch.ops.flux import barr

__all__ = ["barr_simple", "init_test"]

_NU_FLAVS = [
    "nue_cc", "numu_cc", "nutau_cc", "nue_nc", "numu_nc", "nutau_nc",
]
_NUBAR_FLAVS = [
    "nuebar_cc", "numubar_cc", "nutaubar_cc", "nuebar_nc", "numubar_nc",
    "nutaubar_nc",
]

_EGY_PIVOT = 24.0900951261  # GeV (reference barr_simple.py)


def _apply_ratio_scale_sum_constant(ratio_scale, in1, in2):
    """Scale the in1/in2 ratio keeping in1+in2 fixed; (0,0) stays (0,0)
    (reference ``apply_ratio_scale``)."""
    denom = torch.where(in2 != 0, in2, 1.0)
    orig_ratio = in1 / denom
    orig_sum = in1 + in2
    new2 = orig_sum / (1.0 + ratio_scale * orig_ratio)
    new1 = ratio_scale * orig_ratio * new2
    both_zero = (in1 == 0) & (in2 == 0)
    zero = torch.zeros((), dtype=in1.dtype, device=in1.device)
    return torch.where(both_zero, zero, new1), torch.where(both_zero, zero, new2)


class barr_simple(Stage):  # noqa: N801
    """Params: nue_numu_ratio, nu_nubar_ratio, delta_index, Barr_uphor_ratio,
    Barr_nu_nubar_ratio."""

    def __init__(self, **std_kwargs):
        super().__init__(
            expected_params=(
                "nue_numu_ratio",
                "nu_nubar_ratio",
                "delta_index",
                "Barr_uphor_ratio",
                "Barr_nu_nubar_ratio",
            ),
            expected_container_keys=(
                "true_energy",
                "true_coszen",
                "nu_flux_nominal",
                "nubar_flux_nominal",
                "nubar",
            ),
            **std_kwargs,
        )

    # writes nu_flux only; never touches the event weights
    stacked_rate_defer_safe = True
    supports_shard = True

    def stacked_ok(self):
        """In grid calc mode the grid is shared across categories and the
        modified flux depends only on the nubar sign, so one two-row chain
        serves all categories; in the per-event calc mode the same math runs
        over the (C, n_pad) stacked events."""
        return self.is_map or self.calc_mode == "events"

    def prepare_stacked(self, data):
        """The parameter-free Barr fields on the calc grid or the stacked
        events, once, so that a template does only rational ops on them (the
        factored forms of ``ops/flux/barr.py``). The stacked events' padded
        slots are sanitized here (energy 1 GeV, coszen 0): their weights are
        0, but a NaN would still reach the parameters' gradients through
        0 * NaN cotangent products."""
        for container in data.containers:
            prev = container.representation
            container.representation = self.calc_mode
            try:
                energy = container["true_energy"]
                coszen = container["true_coszen"]
                if not self.is_map:
                    valid = ~(torch.isnan(energy) | torch.isnan(coszen))
                    energy = torch.where(valid, energy, 1.0)
                    coszen = torch.where(valid, coszen, 0.0)
                container["barr_nubar_field_e"] = barr.nubar_mod_field(
                    0, energy, coszen
                )
                container["barr_nubar_field_mu"] = barr.nubar_mod_field(
                    1, energy, coszen
                )
                container["barr_uphor_field_e"] = barr.uphor_mod_field(
                    0, energy, coszen
                )
                container["barr_log_e_pivot"] = torch.log(energy / _EGY_PIVOT)
            finally:
                container.representation = prev

    @staticmethod
    def _ratios_on_fields(container, params):
        """The nue/numu ratio, spectral tilt and nu/nubar ratio applied to
        the stacked container's nominal flux pairs, on the precomputed
        log(E / E_pivot): (e_nu, e_nub, mu_nu, mu_nub)."""
        nue_numu_ratio, nu_nubar_ratio, delta_index = params[:3]
        nu_flux = container["nu_flux_nominal"]
        nubar_flux = container["nubar_flux_nominal"]
        nu_e, nu_mu = _apply_ratio_scale_sum_constant(
            nue_numu_ratio, nu_flux[..., 0], nu_flux[..., 1]
        )
        nub_e, nub_mu = _apply_ratio_scale_sum_constant(
            nue_numu_ratio, nubar_flux[..., 0], nubar_flux[..., 1]
        )
        idx_scale = barr.spectral_index_scale_from_log(
            container["barr_log_e_pivot"], delta_index
        )
        nu_e, nu_mu = nu_e * idx_scale, nu_mu * idx_scale
        nub_e, nub_mu = nub_e * idx_scale, nub_mu * idx_scale
        e_nu, e_nub = _apply_ratio_scale_sum_constant(
            nu_nubar_ratio, nu_e, nub_e
        )
        mu_nu, mu_nub = _apply_ratio_scale_sum_constant(
            nu_nubar_ratio, nu_mu, nub_mu
        )
        return e_nu, e_nub, mu_nu, mu_nub

    def _compute_stacked(self, container, params):
        """One chain giving the (2, ngrid, 2) nu/nubar flux pair, with rows
        mapping each category to its sign; the per-sign intermediates are
        shared where the linked path computes them once per group."""
        uphor, barr_nubar = params[3:]
        nu_flux = container["nu_flux_nominal"]
        if nu_flux.dim() != (2 if container.lanes is None else 3):
            raise ValueError(
                "stacked barr_simple expects a shared nominal flux on the"
                f" calc grid; got shape {tuple(nu_flux.shape)}"
            )
        e_nu, e_nub, mu_nu, mu_nub = self._ratios_on_fields(container, params)
        field_e = container["barr_nubar_field_e"]
        field_mu = container["barr_nubar_field_mu"]
        uphor_e = barr.mod_ratio_uphor_from_field(
            container["barr_uphor_field_e"], uphor
        )
        out_rows = []
        for nubar, out_e, out_mu in ((1, e_nu, mu_nu), (-1, e_nub, mu_nub)):
            oe = out_e * barr.mod_ratio_nubar_from_field(
                nubar, field_e, barr_nubar
            )
            om = out_mu * barr.mod_ratio_nubar_from_field(
                nubar, field_mu, barr_nubar
            )
            out_rows.append(torch.stack(
                torch.broadcast_tensors(oe * uphor_e, om), dim=-1))
        rows = (np.asarray(container.cat_aux("nubar")) < 0).astype(np.int32)
        container.set_stacked("nu_flux", torch.stack(out_rows, dim=-3),
                              rows=rows)

    def _compute_stacked_events(self, container, params):
        """The per-event flux over the (C, n_pad) stacked events
        (``_compute_stacked_events`` :195 of the JAX package): the grid
        chain over the stacked events, each category's nubar sign a (C, 1)
        select. In an evaluation of lanes a (B, 1) magnitude gets the
        categories' axis, (B, 1, 1), against the (B, C, n_pad) events."""
        params = [p[..., None] if isinstance(p, torch.Tensor) and p.dim()
                  else p for p in params]
        uphor, barr_nubar = params[3:]
        e_nu, e_nub, mu_nu, mu_nub = self._ratios_on_fields(container, params)
        sign = container.row_tensor(container.cat_aux("nubar")).to(
            e_nu.dtype)[:, None]  # (C, 1)
        out_e = torch.where(sign < 0, e_nub, e_nu)
        out_mu = torch.where(sign < 0, mu_nub, mu_nu)
        out_e = out_e * barr.mod_ratio_nubar_from_field_signed(
            sign, container["barr_nubar_field_e"], barr_nubar
        ) * barr.mod_ratio_uphor_from_field(
            container["barr_uphor_field_e"], uphor
        )
        out_mu = out_mu * barr.mod_ratio_nubar_from_field_signed(
            sign, container["barr_nubar_field_mu"], barr_nubar
        )
        container["nu_flux"] = torch.stack(
            torch.broadcast_tensors(out_e, out_mu), dim=-1)

    def compute_function(self):
        p = self.params
        nue_numu_ratio, nu_nubar_ratio, delta_index, uphor, barr_nubar = (
            in_data_type(p[name].m_as("dimensionless"))
            for name in ("nue_numu_ratio", "nu_nubar_ratio", "delta_index",
                         "Barr_uphor_ratio", "Barr_nu_nubar_ratio"))

        if any(getattr(c, "is_stacked", False) for c in self.data.containers):
            compute = (self._compute_stacked if self.is_map
                       else self._compute_stacked_events)
            for container in self.data:
                compute(container, (nue_numu_ratio, nu_nubar_ratio,
                                    delta_index, uphor, barr_nubar))
            return

        # grid mode: the modified flux depends only on the shared grid, the
        # flavour-independent nominal flux pair and the nubar sign, so the
        # flavour containers are linked and the math runs twice (nu, nubar)
        if self.is_map:
            self.data.link_containers("nu", _NU_FLAVS)
            self.data.link_containers("nubar", _NUBAR_FLAVS)

        for container in self.data:
            energy = container["true_energy"]
            coszen = container["true_coszen"]
            nu_flux = container["nu_flux_nominal"]
            nubar_flux = container["nubar_flux_nominal"]
            nubar = int(container["nubar"])

            # nue/numu ratio on both nu and nubar nominal pairs
            nu_e, nu_mu = _apply_ratio_scale_sum_constant(
                nue_numu_ratio, nu_flux[..., 0], nu_flux[..., 1]
            )
            nub_e, nub_mu = _apply_ratio_scale_sum_constant(
                nue_numu_ratio, nubar_flux[..., 0], nubar_flux[..., 1]
            )

            # spectral index
            idx_scale = barr.spectral_index_scale(
                energy, _EGY_PIVOT, delta_index
            )
            nu_e, nu_mu = nu_e * idx_scale, nu_mu * idx_scale
            nub_e, nub_mu = nub_e * idx_scale, nub_mu * idx_scale

            # nu/nubar ratio per flavour
            e_nu, e_nub = _apply_ratio_scale_sum_constant(
                nu_nubar_ratio, nu_e, nub_e
            )
            mu_nu, mu_nub = _apply_ratio_scale_sum_constant(
                nu_nubar_ratio, nu_mu, nub_mu
            )
            if nubar < 0:
                out_e, out_mu = e_nub, mu_nub
            else:
                out_e, out_mu = e_nu, mu_nu

            # Barr modifications
            out_e = out_e * barr.mod_ratio_nubar(
                nubar, 0, energy, coszen, barr_nubar
            )
            out_mu = out_mu * barr.mod_ratio_nubar(
                nubar, 1, energy, coszen, barr_nubar
            )
            out_e = out_e * barr.mod_ratio_uphor(0, energy, coszen, uphor)
            out_mu = out_mu * barr.mod_ratio_uphor(1, energy, coszen, uphor)

            container["nu_flux"] = torch.stack(
                torch.broadcast_tensors(out_e, out_mu), dim=-1)
        self.data.unlink_containers()


def init_test(**param_kwargs):
    """Instantiation example."""
    param_set = ParamSet(
        [
            Param(name="nue_numu_ratio", value=1.0, **param_kwargs),
            Param(name="nu_nubar_ratio", value=1.0, **param_kwargs),
            Param(name="delta_index", value=0.0, **param_kwargs),
            Param(name="Barr_uphor_ratio", value=0.0, **param_kwargs),
            Param(name="Barr_nu_nubar_ratio", value=0.0, **param_kwargs),
        ]
    )
    return barr_simple(params=param_set)
