"""
Barr-2006 parameterized atmospheric-flux modifications as torch ops.

Counterpart of ``pisa_tpu/ops/flux/barr.py`` (reference
``pisa/utils/barr_parameterization.py``). `flav` (0=e, 1=mu) and `nubar`
are static python ints; the fit coefficients are python floats; the
systematics are floats or 0-d tensors (a compiled template differentiates
through them); the energies and coszens are tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "mod_flux",
    "mod_ratio_uphor",
    "mod_ratio_nubar",
    "spectral_index_scale",
    "nubar_mod_field",
    "mod_ratio_nubar_from_field",
    "uphor_mod_field",
    "mod_ratio_uphor_from_field",
    "spectral_index_scale_from_log",
]


def _log_log_param(true_energy, y1, y2, x1, x2, cutoff_value=None):
    """Power-law interpolation in log-log space between (x1, y1), (x2, y2)
    (reference ``LogLogParam``, ``barr_parameterization.py:27``)."""
    nu_nubar = float(np.sign(y2))
    y1_ = float(np.sign(y1)) * math.log10(abs(y1) + 0.0001)
    y2_ = math.log10(abs(y2 + 0.0001))
    modification = nu_nubar * torch.pow(
        10.0,
        ((y2_ - y1_) / (x2 - x1)) * (torch.log10(true_energy) - x1) + y1_ - 2.0,
    )
    if cutoff_value is not None:
        modification = modification * torch.exp(-true_energy / cutoff_value)
    return modification


def _norm_fcn(x, amplitude, sigma):
    return (
        amplitude
        / math.sqrt(2 * math.pi * sigma**2)
        * torch.exp(-(x**2) / (2 * sigma**2))
    )


# fit constants (Barr 2006 figs. 7 & 9; reference ModFlux)
_E1MAX_MU, _E2MAX_MU = 3.0, 43.0
_E1MAX_E, _E2MAX_E = 2.5, 10.0
_X1E, _X2E = 0.5, 3.0
_Z1MAX_MU, _Z2MAX_MU = 0.6, 5.0
_Z1MAX_E, _Z2MAX_E = 0.3, 5.0
_NUE_CUTOFF, _NUMU_CUTOFF = 650.0, 1000.0
_X1Z, _X2Z = 0.5, 2.0


def mod_flux(flav, true_energy, true_coszen, e1mu, e2mu, z1mu, z2mu, e1e,
             e2e, z1e, z2e):
    """Barr flux modification for flavour `flav` (0=e, 1=mu)
    (reference ``ModFlux``, ``barr_parameterization.py:43``)."""
    if flav == 1:
        a_ave = _log_log_param(
            true_energy, _E1MAX_MU * e1mu, _E2MAX_MU * e2mu, _X1E, _X2E
        )
        a_shape = 2.5 * _log_log_param(
            true_energy, _Z1MAX_MU * z1mu, _Z2MAX_MU * z2mu, _X1Z, _X2Z,
            cutoff_value=_NUMU_CUTOFF,
        )
        return a_ave - (_norm_fcn(true_coszen, a_shape, 0.36) - 0.6 * a_shape)
    if flav == 0:
        a_ave = _log_log_param(
            true_energy,
            _E1MAX_MU * e1mu + _E1MAX_E * e1e,
            _E2MAX_MU * e2mu + _E2MAX_E * e2e,
            _X1E,
            _X2E,
        )
        a_shape = 1.0 * _log_log_param(
            true_energy,
            _Z1MAX_MU * z1mu + _Z1MAX_E * z1e,
            _Z2MAX_MU * z2mu + _Z2MAX_E * z2e,
            _X1Z,
            _X2Z,
            cutoff_value=_NUE_CUTOFF,
        )
        return a_ave - (
            1.5 * _norm_fcn(true_coszen, a_shape, 0.36) - 0.7 * a_shape
        )
    raise ValueError(f"flav must be 0 or 1; got {flav}")


def mod_ratio_uphor(flav, true_energy, true_coszen, uphor):
    """Up/horizontal ratio modification (reference ``modRatioUpHor``)."""
    if flav == 0:
        a_shape = abs(uphor) * _log_log_param(
            true_energy,
            _Z1MAX_E + _Z1MAX_MU,
            _Z2MAX_E + _Z2MAX_MU,
            _X1Z,
            _X2Z,
            cutoff_value=_NUE_CUTOFF,
        )
        # float64: as a float32 0-d tensor the product 0.3 * sign would be
        # rounded to float32 before it meets float64 coordinates
        sign = torch.sign(torch.as_tensor(uphor, dtype=torch.float64))
        return 1.0 - 0.3 * sign * _norm_fcn(true_coszen, a_shape, 0.35)
    if flav == 1:
        return torch.ones_like(true_energy)
    raise ValueError(f"flav must be 0 or 1; got {flav}")


def mod_ratio_nubar(nubar, flav, true_energy, true_coszen, nubar_sys):
    """nu/nubar ratio modification; `nubar` static +-1
    (reference ``modRatioNuBar``)."""
    modfactor = nubar_sys * mod_flux(
        flav, true_energy, true_coszen, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0
    )
    if nubar < 0:
        return torch.clamp(1.0 / (1.0 + 0.5 * modfactor), min=0.0)
    return torch.clamp(1.0 + 0.5 * modfactor, min=0.0)


# -- factored forms --------------------------------------------------------------
#
# The Barr modifications are transcendental fields of (E, coszen) whose
# parameters enter only linearly or as outer factors:
#
# - ``mod_ratio_nubar`` calls ``mod_flux`` with unit coefficients, so its
#   field M_flav(E, cz) is parameter-free: mod = max(0, 1 +- 0.5 sys M);
# - ``mod_ratio_uphor`` (flav 0): ``_norm_fcn(x, A, s)`` is linear in its
#   amplitude A = |uphor| L(E), so
#   mod = 1 - 0.3 sign(u) _norm_fcn(cz, |u| L, .35) = 1 - 0.3 u L(E) N(cz).
#
# On fixed coordinates (a calc grid) the fields are evaluated once, and a
# template does a few rational ops on them: no log10/pow/exp and none of
# their reverse-pass twins. The factored forms are the same expressions
# reassociated, equal to the direct ones up to one rounding.


def nubar_mod_field(flav, true_energy, true_coszen):
    """Parameter-free field M_flav of :func:`mod_ratio_nubar`."""
    return mod_flux(
        flav, true_energy, true_coszen, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0
    )


def mod_ratio_nubar_from_field(nubar, field, nubar_sys):
    """:func:`mod_ratio_nubar` from its :func:`nubar_mod_field`."""
    modfactor = nubar_sys * field
    if nubar < 0:
        return torch.clamp(1.0 / (1.0 + 0.5 * modfactor), min=0.0)
    return torch.clamp(1.0 + 0.5 * modfactor, min=0.0)


def mod_ratio_nubar_from_field_signed(sign, field, nubar_sys):
    """:func:`mod_ratio_nubar_from_field` with a tensor of nubar signs (one
    +-1 per stacked category row, broadcast against the field), for the
    category-stacked per-event flux."""
    modfactor = nubar_sys * field
    plus = torch.clamp(1.0 + 0.5 * modfactor, min=0.0)
    minus = torch.clamp(1.0 / (1.0 + 0.5 * modfactor), min=0.0)
    return torch.where(sign < 0, minus, plus)


def uphor_mod_field(flav, true_energy, true_coszen):
    """Parameter-free field P_flav with
    ``mod_ratio_uphor == 1 - 0.3 * uphor * P`` (P = 0 for flav 1)."""
    if flav == 1:
        return torch.zeros_like(true_energy)
    if flav != 0:
        raise ValueError(f"flav must be 0 or 1; got {flav}")
    amp = _log_log_param(
        true_energy,
        _Z1MAX_E + _Z1MAX_MU,
        _Z2MAX_E + _Z2MAX_MU,
        _X1Z,
        _X2Z,
        cutoff_value=_NUE_CUTOFF,
    )
    return amp * _norm_fcn(true_coszen, 1.0, 0.35)


def mod_ratio_uphor_from_field(field, uphor):
    """:func:`mod_ratio_uphor` from its :func:`uphor_mod_field`."""
    return 1.0 - 0.3 * uphor * field


def spectral_index_scale(true_energy, egy_pivot, delta_index):
    """(E / E_pivot)^delta_index."""
    return torch.pow(true_energy / egy_pivot, delta_index)


def spectral_index_scale_from_log(log_e_over_pivot, delta_index):
    """:func:`spectral_index_scale` from ``log(E / E_pivot)``."""
    return torch.exp(delta_index * log_e_over_pivot)
