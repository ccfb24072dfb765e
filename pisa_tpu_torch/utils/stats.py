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
inputs' device, differentiable in `expected`. Every metric is branch-free
and runs a fixed number of tensor operations (the Barlow-Beeston solve its
30 Newton steps, the generalized mixture its ``k_max`` recursion steps), so
that each can be captured in a CUDA graph with no read on the host.
"""

from __future__ import annotations

import numpy as np
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
    "mcllh_mean",
    "mcllh_eff",
    "barlow_llh",
    "barlow_solve_t",
    "conv_llh",
    "generalized_poisson_llh",
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
    """The per-bin function of `metric`; raises for unknown metrics."""
    if metric not in ALL_METRICS:
        raise ValueError(f"Unknown metric {metric!r}; valid: {ALL_METRICS}")
    return globals()[metric]


def _like(variance, e):
    """`variance` as a tensor shaped like `e` on its device: a number is
    filled in there (no copy from the host, which a CUDA graph capture
    refuses), a tensor broadcast."""
    if isinstance(variance, torch.Tensor):
        return variance + torch.zeros_like(e)
    if np.ndim(variance) == 0:
        return torch.full_like(e, float(variance))
    return torch.as_tensor(np.asarray(variance), dtype=e.dtype,
                           device=e.device) + torch.zeros_like(e)


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


def _poisson_gamma(data, sum_w, sum_w2, a=1.0, b=0.0):
    """Poisson-gamma mixture llh (Arguelles, Schneider, Yuan,
    JHEP06(2019)030; ``pisa_tpu/utils/stats.py:168``): a = b = 0 gives
    L_Mean, a = 1, b = 0 L_Eff. Branch-free: a bad bin (w <= 0 or w2 < 0)
    gives -inf, or 0 where the data is 0; w2 == 0 takes the Poisson
    limit."""
    w = torch.as_tensor(sum_w)
    k = torch.as_tensor(data, device=w.device)
    w2 = torch.as_tensor(sum_w2, device=w.device)

    bad = (w <= 0) | (w2 < 0)
    poisson_lim = (w2 == 0) & ~bad

    w2_safe = torch.where(w2 > 0, w2, torch.ones_like(w2))
    alpha = torch.square(w) / w2_safe + a
    beta = w / w2_safe + b
    L = (
        alpha * torch.log(beta)
        + torch.lgamma(k + alpha)
        - torch.lgamma(k + 1.0)
        - (k + alpha) * torch.log1p(beta)
        - torch.lgamma(alpha)
    )
    L = torch.where(poisson_lim, poisson_llh(k, w), L)
    return torch.where(bad, torch.where(k == 0, torch.zeros_like(L),
                                        torch.full_like(L, -torch.inf)), L)


def mcllh_mean(actual, expected, variance=0.0):
    """L_Mean of JHEP06(2019)030 table 2 (reference ``stats.py:328``)."""
    a, e = _pair(actual, expected)
    return _poisson_gamma(a, e, _like(variance, e), a=0.0, b=0.0)


def mcllh_eff(actual, expected, variance=0.0):
    """L_Eff, eq. 3.16 of JHEP06(2019)030 (reference ``stats.py:384``)."""
    a, e = _pair(actual, expected)
    return _poisson_gamma(a, e, _like(variance, e), a=1.0, b=0.0)


def barlow_llh(actual, expected, variance=0.0):
    """Barlow-Beeston llh per bin (reference ``stats.py:598`` and
    ``pisa/utils/barlow.py:64``; Barlow and Beeston,
    doi:10.1016/0010-4655(93)90005-W), 0-referenced by the saturated MC
    term.

    A single source (`expected` and `variance` shaped like `actual`) has
    the closed-form profile A = (d + N) / (1 + w) of the latent MC count,
    with N = e^2/var unweighted events of weight w = var/e. Several
    sources (`expected` and `variance` with a leading source axis) are
    profiled by :func:`barlow_solve_t`."""
    e_in = torch.as_tensor(expected)
    d = torch.as_tensor(actual, device=e_in.device)
    if e_in.dim() == d.dim() + 1:
        return _barlow_llh_multi(d, e_in, variance)
    e = torch.clamp(e_in, min=SMALL_POS)
    var = torch.clamp(_like(variance, e), min=SMALL_POS)
    N = torch.square(e) / var  # unweighted MC count
    w = var / e  # per-event weight
    A = (d + N) / (1.0 + w)
    f = torch.clamp(w * A, min=SMALL_POS)
    A = torch.clamp(A, min=SMALL_POS)
    llh_data = d * torch.log(f) - f - torch.lgamma(d + 1.0)
    llh_mc = N * torch.log(A) - A - torch.lgamma(N + 1.0)
    llh_mc_sat = (N * torch.log(torch.clamp(N, min=SMALL_POS)) - N
                  - torch.lgamma(N + 1.0))
    return llh_data + llh_mc - llh_mc_sat


def barlow_solve_t(d, w, a, iterations=30):
    """Safeguarded Newton solution of the Barlow-Beeston per-bin equation
    (``pisa_tpu/utils/stats.py:252``; Barlow and Beeston 1993, eq. 13-16):
    t with

        g(t) = sum_j w_j a_j / (1 + w_j t) - d / (1 - t) = 0,

    whence the profiled latent counts are A_j = a_j / (1 + w_j t). g falls
    strictly on (t_min, 1), t_min = -1/max_j w_j; each Newton step is
    clipped into a shrinking sign bracket, for a fixed number of steps
    (no stop that depends on the data); d = 0 gives t = 1 exactly.

    One departure from the JAX package: a step that no longer moves t (the
    root reached to the last bit) keeps t. There the bracket's edge sits at
    t, the strict bracket test fails, and the JAX package bisects away from
    the root and back, so that after its 30 steps a bin can stand ~1e-8
    from the root it had reached (tests/test_torch_metrics.py).

    d (...,) data counts; w (S, ...) each source's per-event weight; a (S,
    ...) each source's unweighted MC count."""
    w = torch.as_tensor(w)
    dtype = w.dtype if w.is_floating_point() else torch.get_default_dtype()
    d = torch.as_tensor(d, dtype=dtype, device=w.device)
    w = torch.clamp(w.to(dtype), min=SMALL_POS)
    a = torch.as_tensor(a, dtype=dtype, device=w.device)

    # clamp the lower bracket for bins without MC, so that the fixed count
    # of bisections stays effective
    w_max = torch.where(a > 0, w, torch.full_like(w, SMALL_POS)).amax(0)
    t_min = torch.clamp(-1.0 / w_max, min=-1e6)
    eps = 1e-9

    lo = t_min + eps * torch.abs(t_min)
    hi = torch.ones_like(lo) - eps
    t = torch.zeros_like(lo)
    for _ in range(iterations):
        u = 1.0 + w * t[None]
        u = torch.where(u <= SMALL_POS, SMALL_POS, u)
        s = torch.sum(w * a / u, dim=0)
        ds = -torch.sum(torch.square(w) * a / torch.square(u), dim=0)
        one_m_t = torch.clamp(1.0 - t, min=SMALL_POS)
        g = s - d / one_m_t
        dg = ds - d / torch.square(one_m_t)
        # keep the sign bracket: g(lo) > 0 > g(hi)
        lo = torch.where(g > 0, t, lo)
        hi = torch.where(g < 0, t, hi)
        t_newton = t - g / torch.where(dg == 0, -1.0, dg)
        inside = ((t_newton > lo) & (t_newton < hi)) | (t_newton == t)
        t = torch.where(inside, t_newton, 0.5 * (lo + hi))
    return torch.where(d > 0, t, torch.ones_like(t))


def _barlow_llh_multi(d, e, variance):
    """Multi-source Barlow-Beeston llh per bin; `e` and `variance` are (S,
    ...) stacks of each source's sum of weights and of squared weights
    (``pisa_tpu/utils/stats.py:310``)."""
    e = torch.clamp(e, min=SMALL_POS)
    var = torch.clamp(_like(variance, e), min=SMALL_POS)
    a = torch.square(e) / var  # unweighted counts N_j
    w = var / e  # per-event weights w_j
    t = barlow_solve_t(d, w, a)
    A = a / torch.clamp(1.0 + w * t[None], min=SMALL_POS)
    f = torch.clamp(torch.sum(w * A, dim=0), min=SMALL_POS)
    A = torch.clamp(A, min=SMALL_POS)
    d = d.to(f.dtype)
    llh_data = d * torch.log(f) - f - torch.lgamma(d + 1.0)
    llh_mc = torch.sum(a * torch.log(A) - A - torch.lgamma(a + 1.0), dim=0)
    llh_mc_sat = torch.sum(
        a * torch.log(torch.clamp(a, min=SMALL_POS)) - a
        - torch.lgamma(a + 1.0), dim=0)
    return llh_data + llh_mc - llh_mc_sat


def conv_llh(actual, expected, variance=0.0, nsigma=3, steps=50):
    """Poisson llh convolved with a normal MC uncertainty, normalized to the
    same convolution at actual == expected (reference ``stats.py:558``;
    ``pisa_tpu/utils/stats.py:334``): a sum over a fixed grid of 2 `steps`
    offsets of sigma per bin."""
    e = torch.clamp(torch.as_tensor(expected), min=SMALL_POS)
    a = torch.as_tensor(actual, device=e.device).to(e.dtype)
    s = torch.clamp(torch.sqrt(_like(variance, e)), min=SMALL_POS)
    st = 2 * steps + 1
    # the offsets in units of sigma: linspace(-n, n, st)[:-1] + n/(st - 1)
    grid = (torch.linspace(-nsigma, nsigma, st, dtype=e.dtype,
                           device=e.device)[:-1] + nsigma / (st - 1.0))

    def norm_conv(k, lam, sig):
        k, lam, sig = k[..., None], lam[..., None], sig[..., None]
        x = grid * sig
        lam_shift = torch.clamp(x + lam, min=SMALL_POS)
        log_pois = k * torch.log(lam_shift) - lam_shift - torch.lgamma(k + 1.0)
        log_gauss = (-0.5 * torch.square(x / sig)
                     - torch.log(sig * (2 * torch.pi) ** 0.5))
        norm = torch.sum(torch.exp(log_gauss), dim=-1)
        cp = torch.sum(torch.exp(log_pois + log_gauss), dim=-1) / norm
        # the continuous-k Poisson density at k = lam normalizes
        lam1 = lam[..., 0]
        n1 = torch.exp(lam1 * torch.log(lam1) - lam1 - torch.lgamma(lam1 + 1.0))
        n2_log_pois = lam * torch.log(lam_shift) - lam_shift - torch.lgamma(
            lam + 1.0)
        n2 = torch.sum(torch.exp(n2_log_pois + log_gauss), dim=-1) / norm
        return cp * n1 / n2

    num = norm_conv(a, e, s)
    den = norm_conv(a, torch.clamp(a, min=SMALL_POS), s)
    return (torch.log(torch.clamp(num, min=SMALL_POS))
            - torch.log(torch.clamp(den, min=SMALL_POS)))


def generalized_poisson_llh(actual, expected=None, empty_bins=None,
                            k_max=None, use_c=False):
    """Generalized Poisson-gamma mixture llh per bin (arXiv:1902.08831 eqs.
    91/97; ``pisa_tpu/utils/stats.py:375``). `expected` maps 'weights',
    'llh_alphas', 'llh_betas' and 'n_mc_events' to (n_sources, n_bins)
    tensors, as the ``likelihood.generalized_llh_params`` stage makes them;
    `k_max` (the recursion's static length, at least the largest data
    count) is taken from the data where not given. ``use_c=True`` takes
    the mixture from the host C library (``utils/llh_defs/native.py``):
    values only, no gradient; it raises where the library cannot be
    built."""
    from pisa_tpu_torch.utils.llh_defs.poisson import generalized_pg_llh

    return generalized_pg_llh(actual, expected, empty_bins=empty_bins,
                              k_max=k_max, use_c=use_c)
