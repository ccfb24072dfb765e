"""
The port's ensemble sampler (``analysis/bayesian.py:mcmc_sampling``, the
Goodman & Weare stretch move over lanes of the compiled template's
objective) against the JAX package's ``pisa_tpu/analysis/bayesian.py``, on
the tiny-grid toy of tests/test_mcmc.py (theta23 free), in fp64 on the
CPU (conftest):

- the batched log posterior at the same walkers equals the JAX package's
  (the negated objective, -inf outside the box) within 1e-9;
- the JAX package's curvature test: the posterior's mean and width against
  a numerical integration of exp(-objective);
- a seed gives the same chain, another seed another one; proposals outside
  the [0, 1] box are rejected.

The two packages draw from different generators, so their chains are
compared through what they sample, not step by step.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu_torch.analysis.bayesian import (
    MCMC_sampling,
    batched_log_prob,
    mcmc_sampling,
)
from pisa_tpu_torch.core.pipeline import Pipeline
from pisa_tpu_torch.utils.resources import find_resource


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX template, port template, the port's Asimov data) of the
    tiny-grid toy with only theta23 free."""
    src = open(find_resource("settings/pipeline/toy_fit_example.cfg")).read()
    path = tmp_path_factory.mktemp("mcmc") / "toy_tiny.cfg"
    path.write_text(src.replace("calc_grid_coarse", "tiny_grid"))
    cts = []
    for cls, kw in ((JaxPipeline, {}), (Pipeline, {"device": "cpu"})):
        p = cls(str(path), **kw)
        for prm in p.params.free:
            if prm.name != "theta23":
                prm.is_fixed = True
        cts.append(p.compile())
    return cts[0], cts[1], cts[1].get_outputs()


def test_log_prob_matches_jax_at_the_same_walkers(setup):
    jax_ct, ct, data = setup
    walkers = np.array([[0.05], [0.3], [0.47], [0.5], [0.62], [0.99],
                        [-0.01], [1.2]])
    got = batched_log_prob(ct, data, "llh", len(walkers))(
        torch.as_tensor(walkers)).numpy()
    jax_value, _ = jax_ct.build_objective(
        {m.name: m.hist for m in data}, "llh")
    inside = (walkers >= 0).all(1) & (walkers <= 1).all(1)
    want = np.array([-float(jax_value(jnp.asarray(w))) for w in walkers])
    np.testing.assert_allclose(got[inside], want[inside], rtol=1e-9)
    assert np.all(got[~inside] == -np.inf)


def test_posterior_matches_likelihood_curvature(setup):
    """tests/test_mcmc.py's check, on the port's sampler."""
    _, ct, data = setup
    chain, logp, acceptance = mcmc_sampling(
        ct, data, metric="llh", n_walkers=16, n_steps=200, n_burnin=100,
        seed=1)
    assert chain.shape == (200, 16, 1) and logp.shape == (200, 16)
    assert 0.1 < acceptance < 0.95, acceptance
    samples = chain[:, :, 0].ravel()

    value_only, _ = ct.build_objective(data, "llh")
    xs = np.linspace(0.0, 1.0, 201)
    neg_logp = np.array([float(value_only(np.asarray([x]))) for x in xs])
    p = np.exp(-(neg_logp - neg_logp.min()))
    p /= np.trapezoid(p, xs)
    mean = np.trapezoid(xs * p, xs)
    std = np.sqrt(np.trapezoid((xs - mean) ** 2 * p, xs))
    assert samples.mean() == pytest.approx(mean, abs=0.3 * std)
    assert samples.std() == pytest.approx(std, rel=0.25)
    # each recorded log posterior is its walker's
    lp = batched_log_prob(ct, data, "llh", 16)
    np.testing.assert_allclose(lp(torch.as_tensor(chain[-1])).numpy(),
                               logp[-1], rtol=1e-12)


def test_chain_is_reproducible_per_seed(setup):
    _, ct, data = setup
    kwargs = dict(metric="llh", n_walkers=8, n_steps=12, n_burnin=6)
    c1, lp1, a1 = mcmc_sampling(ct, data, seed=7, **kwargs)
    c2, lp2, a2 = MCMC_sampling(ct, data, seed=7, **kwargs)
    c3, _, _ = mcmc_sampling(ct, data, seed=8, **kwargs)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(lp1, lp2)
    assert a1 == a2
    assert not np.array_equal(c1, c3)


def test_proposals_outside_the_box_are_rejected(setup):
    """Walkers started at the box's edge with a wide stretch: proposals
    leave the box, none is accepted."""
    _, ct, data = setup
    chain, logp, acceptance = mcmc_sampling(
        ct, data, metric="llh", n_walkers=8, n_steps=10, n_burnin=0,
        stretch_a=6.0, seed=3, x0=[0.999], init_spread=0.3)
    assert np.all((chain >= 0.0) & (chain <= 1.0))
    assert np.all(np.isfinite(logp))
    assert acceptance < 1.0
    with pytest.raises(ValueError, match="even"):
        mcmc_sampling(ct, data, n_walkers=7)


def test_template_lanes_take_their_own_data(setup):
    """The template objective's batched form: lane b with data row b (the
    data's maps end to end) equals the single objective against that
    data."""
    _, ct, data = setup
    names = [m.name for m in data]
    rng = np.random.RandomState(4)
    vecs = np.array([[0.4], [0.55]])
    rows = [{n: rng.poisson(np.clip(data[n].hist.ravel(), 0, None)).astype(
        float) for n in names} for _ in vecs]
    value_fn, _ = ct.build_objective(data, "llh")
    batch = torch.as_tensor(np.stack([np.concatenate([r[n] for n in names])
                                      for r in rows]))
    got = value_fn.raw_with_data(torch.as_tensor(vecs),
                                 *ct._device_bounds(), batch)
    for b, row in enumerate(rows):
        single, _ = ct.build_objective(row, "llh")
        np.testing.assert_allclose(float(got[b]), float(single(vecs[b])),
                                   rtol=1e-12)
