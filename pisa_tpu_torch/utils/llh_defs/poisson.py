"""
Generalized Poisson-gamma mixture likelihood (arXiv:1902.08831, eqs. 91/97).

Counterpart of ``pisa_tpu/utils/llh_defs/poisson.py``: the per-bin delta
recursion

    delta_0 = 1,   delta_i = (1/i) * sum_{j=1..i} s_j * delta_{i-j},
    s_j = sum_sources alpha_s * q_s^j,   q_s = 1/(1+beta_s),
    P(k) = prod_s (beta_s/(1+beta_s))^alpha_s * delta_k

for all bins at once, differentiable in the alphas and betas. The recursion
length ``k_max`` is static (the largest data count, taken when the
objective is built): the powers q^j are one cumulative product, the
recursion ``k_max`` steps of tensor operations, with nothing read on the
host, so that a CUDA graph can capture it. Each step costs O(bins x k_max),
so the recursion's time grows as k_max^2 (``PERF.md`` has it on the card).

Two departures from the JAX package, neither of which changes a value:
a bin whose llh does not come from the mixture (every source holds more
than 100 MC events, or none holds any) feeds the mixture alpha = beta = 1
and k = 0 (the JAX package feeds it the bin's own, and at large counts its
recursion overflows there, which makes its gradient NaN although the
mixture's value is discarded), and :func:`mixture_k_max` takes the
recursion length from the counts of the bins that use the mixture only.

``use_c=True`` takes the mixture from the host C library instead
(``native.py``, the port's copy of the JAX package's ``poisson_gamma.c``):
float64 on the host, values only (no gradient), one host read and one
upload per call, so it cannot be captured in a CUDA graph. It is fed the
same inputs as the torch recursion, and raises where the library cannot be
built.
"""

from __future__ import annotations

import numpy as np
import torch

SMALL_POS = 1e-10
MIN_PROB = 1e-300

__all__ = [
    "generalized_pg_log_mixture",
    "generalized_pg_llh",
    "approximate_poisson_normal",
    "mixture_bins",
    "mixture_k_max",
]

#: a bin whose every source holds more than this many MC events takes the
#: plain Poisson llh (reference stats.py:858-861)
HIGH_MC = 100


def mixture_bins(n_mc_events):
    """Which bins take their llh from the mixture, from the (S, B)
    per-source MC event counts: not every source above :data:`HIGH_MC`,
    and some MC in the bin."""
    n_mc = torch.as_tensor(n_mc_events)
    return ~(n_mc > HIGH_MC).all(0) & (n_mc.sum(0) != 0)


def mixture_k_max(data, n_mc_events):
    """The recursion length for data counts `data` (B,) and (S, B) MC event
    counts, both on the host (numpy): the largest count among the bins that
    use the mixture (:func:`mixture_bins`), at least 1."""
    data = np.asarray(data, dtype=np.float64)
    used = mixture_bins(torch.as_tensor(np.asarray(n_mc_events))).numpy()
    return max(1, int(np.ceil(data[used].max()))) if used.any() else 1


def generalized_pg_log_mixture(k, alphas, betas, mask=None, k_max=None):
    """log P(k) of the generalized Poisson-gamma mixture per bin (eq. 91 of
    1902.08831; ``pisa_tpu/utils/llh_defs/poisson.py:38``).

    k (B,) integer data counts; alphas, betas (B, S) each bin's mixture
    parameters per source; `mask` (B, S) the valid sources (by default the
    finite ones with beta > 0); `k_max` the static recursion length, at
    least max(k) (taken from `k` on the host where not given); larger
    counts are clipped to it."""
    alphas = torch.as_tensor(alphas)
    betas = torch.as_tensor(betas, device=alphas.device)
    k = torch.as_tensor(k, device=alphas.device)
    if mask is None:
        mask = torch.isfinite(alphas) & torch.isfinite(betas) & (betas > 0)
    if k_max is None:
        k_max = int(k.max()) if k.numel() else 0
    k_max = max(int(k_max), 1)
    k = torch.clamp(k, 0, k_max).long()

    zero = torch.zeros_like(alphas)
    a = torch.where(mask, alphas, zero)
    b_safe = torch.where(mask, betas, torch.ones_like(betas))
    q = torch.where(mask, 1.0 / (1.0 + b_safe), zero)  # (B, S)
    # sum_s alpha_s * log(beta_s / (1 + beta_s))
    log_prefac = torch.where(
        mask, a * (torch.log(b_safe) - torch.log1p(b_safe)), zero).sum(-1)

    # s_j = sum_s alpha_s q_s^j, j = 1..k_max: the running product as one
    # cumulative product (the same multiplications in the same order)
    powers = torch.cumprod(q.unsqueeze(-1).expand(q.shape + (k_max,)), -1)
    st = (a.unsqueeze(-1) * powers).sum(-2)  # (B, k_max), st[:, j-1] = s_j

    # the recursion, with the deltas kept newest first: rev holds
    # delta_{i-1}, ..., delta_0 at step i
    rev = torch.ones(a.shape[:-1] + (1,), dtype=a.dtype, device=a.device)
    for i in range(1, k_max + 1):
        delta = (st[:, :i] * rev).sum(-1, keepdim=True) / i
        rev = torch.cat([delta, rev], dim=-1)
    # rev[:, k_max - k] is delta_k
    p_k = torch.gather(rev, 1, (k_max - k)[:, None])[:, 0]
    return log_prefac + torch.log(torch.clamp(p_k, min=MIN_PROB))


def generalized_pg_llh(actual, expected, empty_bins=None, k_max=None,
                       use_c=False):
    """Per-bin generalized Poisson llh (reference ``stats.py:792``;
    ``pisa_tpu/utils/llh_defs/poisson.py:107``).

    actual (B,) data counts; `expected` maps 'weights', 'llh_alphas',
    'llh_betas' and 'n_mc_events' to (S, B) per-source stacks (the
    ``likelihood.generalized_llh_params`` stage's outputs); `empty_bins`
    (B,) bool, the bins with no MC in any source (by default from
    n_mc_events). A bin whose every source holds more than 100 MC events
    takes the plain Poisson llh of the summed weights, saturated model
    subtracted; the others the mixture; an empty bin gives log(SMALL_POS)
    where it holds data, else 0. `k_max` defaults to the largest data
    count (a host read); :func:`mixture_k_max` gives the shortest that
    serves. `use_c` takes the mixture from the host C library
    (:func:`~pisa_tpu_torch.utils.llh_defs.native.pg_log_mixture_c`):
    values only, returned on the inputs' device; it raises where the
    library cannot be built."""
    for key in ("weights", "llh_alphas", "llh_betas", "n_mc_events"):
        if key not in expected:
            raise ValueError(
                f"generalized_poisson_llh needs key {key!r} in expected"
                " (run the likelihood.generalized_llh_params stage)")
    weights = torch.as_tensor(expected["weights"])  # (S, B)
    device = weights.device
    alphas = torch.as_tensor(expected["llh_alphas"], device=device).T  # (B, S)
    betas = torch.as_tensor(expected["llh_betas"], device=device).T
    n_mc = torch.as_tensor(expected["n_mc_events"], device=device)  # (S, B)
    k = torch.as_tensor(actual, device=device).to(weights.dtype)
    k_int = torch.clamp(k, min=0).to(torch.int32)
    if empty_bins is None:
        empty_bins = n_mc.sum(0) == 0

    # high statistics: Poisson against the summed weights, saturated model
    # subtracted (reference stats.py:858-861)
    w_sum = weights.sum(0)
    w_safe = torch.clamp(w_sum, min=SMALL_POS)
    k_safe = torch.clamp(k, min=1.0)
    log_poisson = k * torch.log(w_safe) - w_safe - (k * torch.log(k_safe) - k)
    high_mc = (n_mc > HIGH_MC).all(0)

    # the mixture, fed benign inputs in the bins that do not use it
    used = (~high_mc & ~empty_bins)[:, None]
    one = torch.ones_like(alphas)
    mix_args = (torch.where(used[:, 0], k_int, 0),
                torch.where(used, alphas, one), torch.where(used, betas, one))
    if use_c:
        from pisa_tpu_torch.utils.llh_defs.native import pg_log_mixture_c

        log_mix = torch.as_tensor(
            pg_log_mixture_c(*(t.detach().cpu().numpy() for t in mix_args)),
            dtype=weights.dtype, device=device)
    else:
        log_mix = generalized_pg_log_mixture(*mix_args, k_max=k_max)
    llh = torch.where(high_mc, log_poisson, log_mix)
    penalty = torch.where(k > 0, torch.full_like(llh, float(np.log(SMALL_POS))),
                          torch.zeros_like(llh))
    return torch.where(empty_bins, penalty, llh)


def approximate_poisson_normal(k, alphas, betas, mask=None, n_quad=64):
    """The marginalized Poisson-gamma probability with the mixture
    approximated by one normal of the summed gamma mean and variance,
    integrated against the Poisson by fixed-order Gauss-Legendre quadrature
    over mean +- 5 sigma (reference ``stats.py:881``;
    ``pisa_tpu/utils/llh_defs/poisson.py:178``). k (B,); alphas, betas (B,
    S). Returns (B,) log probabilities."""
    alphas = torch.as_tensor(alphas)
    betas = torch.as_tensor(betas, device=alphas.device)
    k = torch.as_tensor(k, device=alphas.device).to(alphas.dtype)
    if mask is None:
        mask = torch.isfinite(alphas) & torch.isfinite(betas) & (betas > 0)
    a = torch.where(mask, alphas, torch.zeros_like(alphas))
    b = torch.where(mask, betas, torch.ones_like(betas))

    mean = (a / b).sum(-1)
    sigma = torch.sqrt(torch.clamp((a / b**2).sum(-1), min=SMALL_POS))
    lo = torch.clamp(mean - 5.0 * sigma, min=SMALL_POS)
    hi = mean + 5.0 * sigma
    x_gl, w_gl = (torch.as_tensor(v, dtype=a.dtype, device=a.device)
                  for v in np.polynomial.legendre.leggauss(n_quad))
    # [-1, 1] -> [lo, hi] per bin
    lam = 0.5 * (hi - lo)[:, None] * x_gl[None, :] + 0.5 * (hi + lo)[:, None]
    jac = 0.5 * (hi - lo)[:, None]
    log_pois = k[:, None] * torch.log(lam) - lam - torch.lgamma(k[:, None] + 1.0)
    log_norm = (-0.5 * ((lam - mean[:, None]) / sigma[:, None]) ** 2
                - torch.log(sigma[:, None] * (2.0 * np.pi) ** 0.5))
    prob = (w_gl[None, :] * torch.exp(log_pois + log_norm) * jac).sum(1)
    return torch.log(torch.clamp(prob, min=MIN_PROB))
