"""
Binned comparison metrics (llh and chi2 families) as differentiable torch
functions.

Counterpart of ``pisa_tpu/utils/stats.py`` (reference
``pisa/utils/stats.py:43-57``), with the same conventions:

- each metric maps (actual, expected[, variance]) elementwise to per-bin
  values; callers sum for totals;
- ``expected`` is clipped to ``SMALL_POS`` against log/0-division blowups;
- llh-family metrics are maximized, chi2-family ones minimized;
- ``variance`` is the variance attached to the expectation (MC sumw2).

Inputs are tensors (or arrays, converted); the result is a tensor on the
inputs' device, differentiable in `expected`. The Barlow-Beeston,
convolved, Poisson-gamma and generalized likelihoods are not ported yet
(ROADMAP queue 1, item 11): they raise.
"""

from __future__ import annotations

import torch

__all__ = [
    "SMALL_POS",
    "ALL_METRICS",
    "METRICS_TO_MAXIMIZE",
    "METRICS_TO_MINIMIZE",
    "it_got_better",
    "is_metric_to_maximize",
    "metric_function",
    "chi2",
    "llh",
    "poisson_llh",
    "log_poisson",
    "mod_chi2",
    "correct_chi2",
    "weighted_chi2",
    "signed_sqrt_mod_chi2",
]

SMALL_POS = 1e-10

METRICS_TO_MAXIMIZE = [
    "llh",
    "poisson_llh",
    "conv_llh",
    "barlow_llh",
    "mcllh_mean",
    "mcllh_eff",
    "generalized_poisson_llh",
]
METRICS_TO_MINIMIZE = [
    "chi2",
    "mod_chi2",
    "correct_chi2",
    "weighted_chi2",
    "signed_sqrt_mod_chi2",
]
ALL_METRICS = METRICS_TO_MAXIMIZE + METRICS_TO_MINIMIZE
_NOT_PORTED = ("conv_llh", "barlow_llh", "mcllh_mean", "mcllh_eff",
               "generalized_poisson_llh")


def is_metric_to_maximize(metric):
    if isinstance(metric, str):
        metric = [metric]
    if all(m in METRICS_TO_MAXIMIZE for m in metric):
        return True
    if all(m in METRICS_TO_MINIMIZE for m in metric):
        return False
    raise ValueError(f"Metrics {metric} are not compatible")


def it_got_better(new_metric_val, old_metric_val, metric):
    if is_metric_to_maximize(metric):
        return new_metric_val > old_metric_val
    return new_metric_val < old_metric_val


def metric_function(metric):
    """The per-bin function of `metric`; raises for unknown metrics and for
    the likelihoods that are not ported yet."""
    if metric in _NOT_PORTED:
        raise NotImplementedError(
            f"metric {metric!r} is not ported yet (ROADMAP queue 1, item 11)"
        )
    if metric not in ALL_METRICS:
        raise ValueError(f"Unknown metric {metric!r}; valid: {ALL_METRICS}")
    return globals()[metric]


def _pair(actual, expected):
    e = torch.as_tensor(expected)
    a = torch.as_tensor(actual, device=e.device)
    return a, torch.clamp(e, min=SMALL_POS)


# ---------------------------------------------------------------------------
# chi2 family
# ---------------------------------------------------------------------------
def chi2(actual, expected, variance=None):
    """Pearson chi2 = (a - e)^2 / e  (reference ``stats.py:98``)."""
    a, e = _pair(actual, expected)
    return torch.square(a - e) / e


def mod_chi2(actual, expected, variance=0.0):
    """(a - e)^2 / (sigma^2 + e)  (reference ``stats.py:651``)."""
    a, e = _pair(actual, expected)
    return torch.square(a - e) / (variance + e)


def correct_chi2(actual, expected, variance=0.0):
    """mod_chi2 + log(sigma^2 + e): -2x log of the normal approximation to
    the Poisson including the variance normalization (reference
    ``stats.py:697``)."""
    a, e = _pair(actual, expected)
    total_var = variance + e
    return torch.square(a - e) / total_var + torch.log(total_var)


def weighted_chi2(actual, expected, bin_unc2, variance=0.0):
    """(a - e)^2 / (sigma^2 + bin_unc2)  (reference ``stats.py:732``)."""
    a, e = _pair(actual, expected)
    bin_unc2 = torch.as_tensor(bin_unc2, device=e.device)
    return torch.square(a - e) / (variance + torch.clamp(bin_unc2,
                                                         min=SMALL_POS))


def signed_sqrt_mod_chi2(actual, expected, variance=0.0):
    """(a - e) / sqrt(sigma^2 + e)  (reference ``stats.py:762``)."""
    a, e = _pair(actual, expected)
    return (a - e) / torch.sqrt(variance + e)


# ---------------------------------------------------------------------------
# llh family
# ---------------------------------------------------------------------------
def llh(actual, expected, variance=None):
    """Poisson llh with Stirling's approximation of ln(k!):
    a ln(e) - e - (a ln(a) - a)  (reference ``stats.py:169``), in the form
    a (log1p(x) - x) with x = (e - a)/a, which keeps its precision near the
    minimum; a == 0 gives -e (the well-defined limit)."""
    a, e = _pair(actual, expected)
    safe_a = torch.where(a > 0, a, torch.ones_like(a))
    x = (e - safe_a) / safe_a
    per_bin = safe_a * (torch.log1p(x) - x)
    return torch.where(a > 0, per_bin, -e)


def log_poisson(k, lam):
    """ln Poisson(k | lam) with exact ln(k!) via lgamma."""
    lam = torch.as_tensor(lam)
    k = torch.as_tensor(k, device=lam.device)
    return k * torch.log(lam) - lam - torch.lgamma(k + 1.0)


def poisson_llh(actual, expected, variance=None):
    """Exact Poisson llh: a ln(e) - e - ln(a!)  (reference ``stats.py:255``)."""
    a, e = _pair(actual, expected)
    return a * torch.log(e) - e - torch.lgamma(a + 1.0)
