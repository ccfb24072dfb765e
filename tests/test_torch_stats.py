"""
The port's metrics (``pisa_tpu_torch.utils.stats``) and prior penalties
(``Prior.llh_torch``) against the JAX package's (``pisa_tpu.utils.stats``,
``Prior.llh_jax``): values and derivatives on seeded inputs, fp64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pisa_tpu.core.prior import Prior as JaxPrior
from pisa_tpu.utils import stats as jax_stats
from pisa_tpu_torch.core.prior import Prior
from pisa_tpu_torch.utils import stats

METRICS = ["chi2", "mod_chi2", "correct_chi2", "signed_sqrt_mod_chi2", "llh",
           "poisson_llh"]


def _inputs(seed=2):
    rng = np.random.RandomState(seed)
    actual = rng.poisson(20.0, 64).astype(float)
    actual[:4] = 0.0  # empty data bins
    expected = rng.uniform(0.0, 40.0, 64)
    expected[4] = 0.0  # clipped to SMALL_POS
    variance = rng.uniform(0.0, 3.0, 64)
    return actual, expected, variance


@pytest.mark.parametrize("metric", METRICS)
def test_metric_and_derivative_match_jax(metric):
    actual, expected, variance = _inputs()
    takes_variance = metric not in ("chi2", "llh", "poisson_llh")
    extra = (variance,) if takes_variance else ()

    def jax_total(e):
        return jnp.sum(getattr(jax_stats, metric)(actual, e, *extra))

    e = torch.tensor(expected, requires_grad=True)
    fn = stats.metric_function(metric)
    total = fn(torch.as_tensor(actual), e,
               *(torch.as_tensor(x) for x in extra)).sum()
    (grad,) = torch.autograd.grad(total, e)
    want = jax_total(jnp.asarray(expected))
    want_grad = jax.grad(jax_total)(jnp.asarray(expected))
    np.testing.assert_allclose(float(total.detach()), float(want), rtol=1e-12)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               rtol=1e-10, atol=1e-12)


def test_weighted_chi2_and_log_poisson_match_jax():
    actual, expected, variance = _inputs(3)
    bin_unc2 = variance[::-1].copy()
    np.testing.assert_allclose(
        stats.weighted_chi2(torch.as_tensor(actual),
                            torch.as_tensor(expected),
                            torch.as_tensor(bin_unc2)).numpy(),
        np.asarray(jax_stats.weighted_chi2(actual, expected, bin_unc2)),
        rtol=1e-12)
    lam = expected + 1.0
    np.testing.assert_allclose(
        stats.log_poisson(torch.as_tensor(actual), torch.as_tensor(lam)),
        np.asarray(jax_stats.log_poisson(actual, lam)), rtol=1e-12)


def test_metric_families():
    for metric in stats.METRICS_TO_MAXIMIZE:
        assert stats.is_metric_to_maximize(metric)
    for metric in stats.METRICS_TO_MINIMIZE:
        assert not stats.is_metric_to_maximize(metric)
    assert stats.ALL_METRICS == jax_stats.ALL_METRICS
    assert stats.it_got_better(1.0, 2.0, "mod_chi2")
    assert stats.it_got_better(2.0, 1.0, "llh")
    with pytest.raises(ValueError):
        stats.is_metric_to_maximize(["llh", "chi2"])
    # every metric is ported: none raises any more
    for metric in stats.ALL_METRICS:
        assert callable(stats.metric_function(metric)), metric
    with pytest.raises(ValueError, match="no_such_metric"):
        stats.metric_function("no_such_metric")


_SPLINE_KNOTS = np.array([30.0, 30.0, 30.0, 30.0, 40.0, 45.0, 50.0, 60.0,
                          60.0, 60.0, 60.0])
PRIORS = {
    "uniform": dict(kind="uniform", llh_offset=0.5),
    "gaussian": dict(kind="gaussian", mean=0.7, stddev=0.2),
    "linterp": dict(kind="linterp", param_vals=[0.0, 0.5, 1.0, 2.0],
                    llh_vals=[-3.0, -1.0, 0.0, -4.0]),
    "spline": dict(kind="spline", knots=_SPLINE_KNOTS,
                   coeffs=np.array([-9.0, -5.0, -1.0, 0.0, -0.5, -3.0, -8.0]),
                   deg=3),
    "jeffreys": dict(kind="jeffreys", A=0.1, B=10.0),
}
PRIOR_POINTS = {
    "uniform": [0.1, 2.0],
    "gaussian": [0.1, 0.65, 1.3],
    "linterp": [0.2, 0.7, 1.5, -1.0, 3.0],  # outside: held at the ends
    "spline": [33.3, 44.4, 57.7],
    "jeffreys": [0.3, 4.0],
}


@pytest.mark.parametrize("kind", list(PRIORS))
def test_prior_llh_torch_matches_llh_jax(kind):
    port = Prior(**PRIORS[kind])
    ref = JaxPrior(**PRIORS[kind])
    for x in PRIOR_POINTS[kind]:
        xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
        got = port.llh_torch(xt)
        (grad,) = torch.autograd.grad(got, xt)
        want = ref.llh_jax(jnp.asarray(x))
        want_grad = float(jax.grad(lambda v: ref.llh_jax(v))(jnp.asarray(x)))
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-12,
                                   atol=1e-12, err_msg=f"{kind} at {x}")
        np.testing.assert_allclose(float(grad), want_grad, rtol=1e-9,
                                   atol=1e-12,
                                   err_msg=f"{kind} slope at {x}")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(PRIORS))
def test_prior_llh_torch_stays_on_the_card(kind):
    """Every kind of prior takes a 0-d tensor on the card, computes there
    and waits for nothing (its interpolation table is uploaded once, at the
    first call); the values are the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    prior = Prior(**PRIORS[kind])
    xs = [torch.tensor(x, dtype=torch.float64, device="cuda")
          for x in PRIOR_POINTS[kind]]
    prior.llh_torch(xs[0])  # uploads the table of a linterp or spline prior
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [prior.llh_torch(x) for x in xs]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for x, g in zip(PRIOR_POINTS[kind], got):
        assert g.device.type == "cuda"
        want = prior.llh_torch(torch.tensor(x, dtype=torch.float64))
        np.testing.assert_allclose(float(g), float(want), rtol=1e-14,
                                   atol=1e-14)
