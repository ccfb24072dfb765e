"""
The port's MC-uncertainty likelihoods (``pisa_tpu_torch.utils.stats``:
``mcllh_mean``, ``mcllh_eff``, ``barlow_llh`` with ``barlow_solve_t``,
``conv_llh``), the generalized Poisson-gamma mixture
(``utils/llh_defs/poisson.py``) and the Barlow ``Likelihoods`` class
(``utils/barlow.py``) against the JAX package's, per bin, on seeded numpy
inputs in fp64 (conftest): zero data, tiny and zero expectations, zero and
nonzero variance. Values and gradients in the expectation (against
``jax.grad``) within rtol 1e-12.

A bin's llh is a difference of Poisson-sized terms (a ln e, e, ln a!,
their gamma-function counterparts), which the two packages' lgamma round
differently in the last bit; where a bin's value is small beside them (e
near a) its relative error grows. So a value is held to 1e-12 of the larger
of itself and its bin's Poisson scale |a ln e| + e + ln a!, and a gradient
entry to 1e-12 of the largest.
"""

import numpy as np
import pytest
import torch
from scipy.special import gammaln

import jax
import jax.numpy as jnp

from pisa_tpu.utils import stats as jax_stats
from pisa_tpu.utils.barlow import Likelihoods as JaxLikelihoods
from pisa_tpu.utils.llh_defs import poisson as jax_poisson
from pisa_tpu_torch.utils import stats
from pisa_tpu_torch.utils.barlow import Likelihoods
from pisa_tpu_torch.utils.llh_defs import poisson

RTOL = 1e-12
MC_METRICS = ["mcllh_mean", "mcllh_eff", "barlow_llh", "conv_llh"]


def _inputs(seed=4, n=48):
    rng = np.random.RandomState(seed)
    actual = rng.poisson(12.0, n).astype(float)
    actual[:6] = 0.0  # empty data bins
    expected = rng.uniform(0.5, 30.0, n)
    expected[6:9] = [1e-12, 1e-6, 0.0]  # tiny and zero expectations
    expected[0] = 0.0
    variance = rng.uniform(0.1, 5.0, n)
    variance[::4] = 0.0  # zero variance: the Poisson limit
    return actual, expected, variance


def _poisson_scale(actual, expected):
    """|a ln e| + e + ln a! per bin (module docstring)."""
    e = np.clip(expected, stats.SMALL_POS, None)
    return np.abs(actual * np.log(e)) + e + gammaln(actual + 1.0)


def _assert_close_to_scale(got, want, scale):
    """|got - want| <= 1e-12 max(|want|, scale) per bin (module
    docstring); equal infinities pass."""
    same = got == want
    err = np.abs(got - want)
    bound = RTOL * np.maximum(np.abs(want), scale)
    bad = ~same & ~(err <= bound)
    assert not bad.any(), (np.flatnonzero(bad), got[bad], want[bad])


def _port_total(metric, actual, expected, variance):
    e = torch.tensor(expected, requires_grad=True)
    vals = stats.metric_function(metric)(torch.as_tensor(actual), e,
                                         torch.as_tensor(variance))
    (grad,) = torch.autograd.grad(vals.sum(), e)
    return vals.detach().numpy(), grad.numpy()


def _jax_total(metric, actual, expected, variance):
    fn = getattr(jax_stats, metric)
    vals = np.asarray(fn(actual, expected, variance))
    grad = jax.grad(lambda e: jnp.sum(fn(actual, e, variance)))(
        jnp.asarray(expected))
    return vals, np.asarray(grad)


@pytest.mark.parametrize("metric", MC_METRICS)
def test_mc_metric_per_bin_and_gradient_match_jax(metric):
    actual, expected, variance = _inputs()
    got, got_grad = _port_total(metric, actual, expected, variance)
    want, want_grad = _jax_total(metric, actual, expected, variance)
    _assert_close_to_scale(got, want, _poisson_scale(actual, expected))
    np.testing.assert_allclose(got_grad, want_grad, rtol=RTOL,
                               atol=1e-12 * np.abs(want_grad).max())


@pytest.mark.parametrize("metric", ["mcllh_mean", "mcllh_eff"])
def test_poisson_gamma_bad_bins_and_limits(metric):
    """The branch-free cases of ``_poisson_gamma``: w2 == 0 is the Poisson
    llh; a negative variance is a bad bin, 0 without data, -inf with."""
    actual = np.array([0.0, 3.0, 0.0, 5.0])
    expected = np.array([2.0, 2.0, 4.0, 4.0])
    variance = np.array([0.0, 0.0, -1.0, -1.0])
    got = stats.metric_function(metric)(
        torch.as_tensor(actual), torch.as_tensor(expected),
        torch.as_tensor(variance)).numpy()
    want = np.asarray(getattr(jax_stats, metric)(actual, expected, variance))
    np.testing.assert_allclose(got[:2], stats.poisson_llh(
        torch.as_tensor(actual[:2]), torch.as_tensor(expected[:2])).numpy(),
        rtol=RTOL)
    assert got[2] == 0.0 and got[3] == -np.inf
    _assert_close_to_scale(got, want, _poisson_scale(actual, expected))


def test_every_metric_has_a_function():
    for metric in stats.ALL_METRICS:
        assert callable(stats.metric_function(metric)), metric


def _sources(seed=6, n_src=3, n=40):
    rng = np.random.RandomState(seed)
    d = rng.poisson(15.0, n).astype(float)
    d[:4] = 0.0
    w = rng.uniform(0.05, 2.0, (n_src, n))
    a = rng.poisson(20.0, (n_src, n)).astype(float)
    a[0, 4:8] = 0.0  # a source without MC in a few bins
    a[:, 8] = 0.0  # a bin without MC in any source
    return d, w, a


def _barlow_root(d, w, a):
    """The Barlow-Beeston bin equation's root t in (-1/max w, 1), by
    brentq (the published per-bin solution, tests/test_barlow.py)."""
    from scipy.optimize import brentq

    if d == 0:
        return 1.0
    live = a > 0
    lo = -1.0 / w[live].max() if live.any() else -1e6

    def g(t):
        return np.sum(w * a / (1.0 + w * t)) - d / (1.0 - t)

    span = 1.0 - lo
    return brentq(g, lo + 1e-13 * span, 1.0 - 1e-13 * span, xtol=1e-15,
                  rtol=1e-15)


def test_barlow_solve_t_reaches_the_root_and_matches_jax():
    """Every bin's t after the fixed 30 steps is the root (1e-12), and
    equals the JAX package's wherever that stands at the root: the JAX
    package's strict bracket test moves a bin away from a root it has
    reached to the last bit (``barlow_solve_t``'s docstring), which the
    port does not copy."""
    d, w, a = _sources()
    got = stats.barlow_solve_t(torch.as_tensor(d), torch.as_tensor(w),
                               torch.as_tensor(a)).numpy()
    want = np.asarray(jax_stats.barlow_solve_t(d, w, a))
    live = a.sum(0) > 0
    root = np.array([_barlow_root(d[i], w[:, i], a[:, i]) if live[i]
                     else np.nan for i in range(d.size)])
    np.testing.assert_allclose(got[live], root[live], rtol=RTOL, atol=1e-15)
    at_root = live & (np.abs(want - root) <= RTOL * np.abs(root) + 1e-15)
    assert at_root.sum() >= 0.8 * d.size
    np.testing.assert_allclose(got[at_root], want[at_root], rtol=RTOL,
                               atol=1e-15)
    assert np.all(got[d == 0] == 1.0)


def test_barlow_multi_source_per_bin_and_gradient_match_jax():
    """Several sources: (S, bins) stacks of sums of weights and of squared
    weights, profiled by the fixed 30-step Newton solve."""
    d, w, a = _sources()
    e = np.clip(w * a, 0.05, None)
    var = e * w
    got, got_grad = _port_total("barlow_llh", d, e, var)
    want, want_grad = _jax_total("barlow_llh", d, e, var)
    assert got.shape == d.shape
    _assert_close_to_scale(got, want, _poisson_scale(d, e.sum(0)))
    np.testing.assert_allclose(got_grad, want_grad, rtol=RTOL,
                               atol=1e-12 * np.abs(want_grad).max())


def test_barlow_single_source_is_one_source_of_the_multi_source():
    """The closed-form single-source profile and the Newton solve with one
    source agree (bins whose expectation is at least 0.5)."""
    actual, expected, variance = _inputs()
    keep = expected >= 0.5
    actual, expected, variance = actual[keep], expected[keep], variance[keep]
    variance = variance + 0.5
    one = stats.barlow_llh(torch.as_tensor(actual), torch.as_tensor(expected),
                           torch.as_tensor(variance)).numpy()
    multi = stats.barlow_llh(torch.as_tensor(actual),
                             torch.as_tensor(expected[None]),
                             torch.as_tensor(variance[None])).numpy()
    _assert_close_to_scale(multi, one, _poisson_scale(actual, expected))


@pytest.mark.parametrize("llh_type", ["barlow", "poisson"])
def test_likelihoods_class_matches_jax(llh_type):
    d, w, a = _sources(n=16)
    shape = (4, 4)
    results = []
    for cls in (Likelihoods, JaxLikelihoods):
        llh = cls()
        llh.set_data(d.reshape(shape))
        llh.set_mc(w.reshape((-1,) + shape))
        llh.set_unweighted(a.reshape((-1,) + shape))
        value = llh.get_llh(llh_type)
        results.append((value, llh.get_plot(), llh.get_single_plots(),
                        llh.get_llh_barlow_bin(a[:, 3] * 0.9, 3)))
    (got, plot, singles, bin_llh), (want, want_plot, want_singles,
                                    want_bin) = results
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(plot, want_plot, rtol=RTOL)
    np.testing.assert_allclose(singles, want_singles, rtol=RTOL)
    np.testing.assert_allclose(bin_llh, want_bin, rtol=RTOL)
    with pytest.raises(ValueError, match="llh_type"):
        Likelihoods().get_llh("bogus")


def _mixture_inputs(seed=9, n=24, n_src=3):
    rng = np.random.RandomState(seed)
    k = rng.poisson(6.0, n)
    k[:3] = 0
    alphas = rng.uniform(0.5, 20.0, (n, n_src))
    betas = rng.uniform(0.2, 5.0, (n, n_src))
    mask = rng.uniform(size=(n, n_src)) > 0.2
    mask[:, 0] = True
    return k, alphas, betas, mask


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("k_max", [None, 30, 4])
def test_generalized_mixture_matches_jax(with_mask, k_max):
    """log P(k) of the mixture and its gradient in the alphas and betas,
    with and without a mask of sources; k_max = 4 clips the larger
    counts."""
    k, alphas, betas, mask = _mixture_inputs()
    m = mask if with_mask else None
    a_t = torch.tensor(alphas, requires_grad=True)
    b_t = torch.tensor(betas, requires_grad=True)
    got = poisson.generalized_pg_log_mixture(
        torch.as_tensor(k), a_t, b_t,
        None if m is None else torch.as_tensor(m), k_max=k_max)
    ga, gb = torch.autograd.grad(got.sum(), (a_t, b_t))

    def jax_fn(a, b):
        return jax_poisson.generalized_pg_log_mixture(k, a, b, mask=m,
                                                       k_max=k_max)

    want = np.asarray(jax_fn(alphas, betas))
    wa, wb = jax.grad(lambda a, b: jnp.sum(jax_fn(a, b)), argnums=(0, 1))(
        jnp.asarray(alphas), jnp.asarray(betas))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL)
    for g, w_ in ((ga, wa), (gb, wb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-10,
                                   atol=1e-12 * np.abs(np.asarray(w_)).max())


def test_generalized_llh_and_normal_approximation_match_jax():
    k, alphas, betas, _ = _mixture_inputs()
    rng = np.random.RandomState(3)
    n_mc = rng.randint(0, 200, (3, k.size)).astype(float)
    n_mc[:, 5] = 0.0  # an empty bin
    n_mc[:, 6] = 150.0  # a bin of high MC statistics
    expected = {"weights": (alphas / betas).T, "llh_alphas": alphas.T,
                "llh_betas": betas.T, "n_mc_events": n_mc}
    got = stats.generalized_poisson_llh(
        torch.as_tensor(k, dtype=torch.float64),
        {key: torch.as_tensor(v) for key, v in expected.items()}).numpy()
    want = np.asarray(jax_stats.generalized_poisson_llh(
        k.astype(float), expected))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(
        poisson.approximate_poisson_normal(
            torch.as_tensor(k), torch.as_tensor(alphas),
            torch.as_tensor(betas)).numpy(),
        np.asarray(jax_poisson.approximate_poisson_normal(k, alphas, betas)),
        rtol=RTOL)
    # the host C route (the C library's own recursion) gives the same
    np.testing.assert_allclose(
        stats.generalized_poisson_llh(
            torch.as_tensor(k, dtype=torch.float64),
            {key: torch.as_tensor(v) for key, v in expected.items()},
            use_c=True).numpy(), want, rtol=RTOL)
    with pytest.raises(ValueError, match="llh_alphas"):
        stats.generalized_poisson_llh(torch.as_tensor(k), {"weights": 1})
