"""
Lanes under prob3's options (``container.lanes``: B parameter points in one
program), in fp64 on the CPU (conftest), on the toy ``osc_example_coarse.
cfg`` with its grids cut to ``tiny_grid`` (8x8) and the options as
tests/test_torch_prob3_options.py builds them.

(c) ``fit_batch_on_device`` against the JAX package's (its vmapped
    L-BFGS) on the same seeded Poisson data lanes from the same starts, at
    tests/test_torch_batch_fit.py's bounds (``nit`` equal, x within 1e-8
    rescaled, fun within 1e-9 relative): 3 lanes, 10 steps, under NSI
    (standard) and decay.
(d) The batched objective (``value_fn.raw_with_data``) under every option:
    each lane's value and gradient against its single-point evaluation,
    1e-12 relative (the flagship's ``calc_mode = events`` at 1% of its
    events: tests/test_torch_prob3_options.py, on its template).
(e) MCMC's batched log posterior under NSI against the JAX package's
    objective at the same walkers (tests/test_torch_mcmc.py's check).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pisa_tpu.analysis import device_fit as jax_device_fit
from pisa_tpu.analysis.gradient import (
    CompiledDistribution as JaxCompiledDistribution,
)
from pisa_tpu.core.distribution_maker import (
    DistributionMaker as JaxDistributionMaker,
)
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu_torch.analysis import device_fit
from pisa_tpu_torch.analysis.bayesian import batched_log_prob
from pisa_tpu_torch.analysis.gradient import CompiledDistribution
from pisa_tpu_torch.core.distribution_maker import DistributionMaker
from pisa_tpu_torch.core.pipeline import Pipeline
from test_torch_prob3_options import (  # noqa: F401 (fixtures)
    COUPLING,
    OPTIONS,
    _lanes_match_single_points,
    _toy,
    five_layer_model,
    tiny_toy,
)

FIT_STEPS = 10


@pytest.mark.parametrize("option", ["nsi-standard", "decay"])
def test_batch_fit_under_option_matches_jax(option, tiny_toy):
    free = COUPLING[option]
    jax_cd = JaxCompiledDistribution(JaxDistributionMaker(
        [_toy(option, "jax", free=free, path=tiny_toy)]))
    cd = CompiledDistribution(DistributionMaker(
        [_toy(option, "torch", free=free, path=tiny_toy)], device="cpu"))
    assert cd.free_names == jax_cd.free_names and free in cd.free_names
    x_nom = np.asarray(jax_cd.current_rescaled_values())
    asimov = np.asarray(jax_cd.sum_hist(x_nom))
    rng = np.random.RandomState(12)
    data = rng.poisson(np.clip(asimov, 0, None),
                       (3, asimov.size)).astype(np.float64)
    x0 = np.clip(x_nom + rng.uniform(-0.05, 0.05, (3, x_nom.size)),
                 0.02, 0.98)
    value_fn, _ = jax_cd.build_objective(asimov, "llh")
    want = jax_device_fit.fit_batch_on_device(
        value_fn.raw_with_data, x0, *jax_cd._current_bounds(),
        jax_cd._all_data_vals(), data, max_steps=FIT_STEPS)
    value_fn, _ = cd.build_objective(asimov, "llh")
    got = device_fit.fit_batch_on_device(
        value_fn.raw_with_data, x0, *cd._current_bounds(), data,
        max_steps=FIT_STEPS, device="cpu")
    (want_x, want_f, want_n), (got_x, got_f, got_n) = (
        [np.asarray(w) for w in want], [g.numpy() for g in got])
    np.testing.assert_array_equal(got_n, want_n)
    assert np.all(got_n > 0)
    np.testing.assert_allclose(got_x, want_x, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got_f, want_f, rtol=1e-9)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_batched_objective_under_option_matches_single(option, tiny_toy,
                                                       five_layer_model):
    free = COUPLING.get(option)
    ct = Pipeline(_toy(option, "torch", five_layer_model, free=free,
                       path=tiny_toy), device="cpu").compile()
    assert free is None or free in ct.free_names
    _lanes_match_single_points(ct)


def test_mcmc_log_prob_under_nsi_matches_jax(tiny_toy):
    """batched_log_prob (the walkers as lanes) under NSI against the JAX
    package's objective at the same walkers: the negated value within
    1e-9, -inf outside the box."""
    free = COUPLING["nsi-standard"]
    jax_ct = JaxPipeline(_toy("nsi-standard", "jax", free=free,
                              path=tiny_toy)).compile()
    ct = Pipeline(_toy("nsi-standard", "torch", free=free, path=tiny_toy),
                  device="cpu").compile()
    assert ct.free_names == jax_ct.free_names
    data = ct.get_outputs()
    v0 = ct.current_rescaled_values()
    rng = np.random.RandomState(6)
    walkers = np.clip(v0 + rng.uniform(-0.2, 0.2, (4, v0.size)), 0.01, 0.99)
    walkers[3, 0] = 1.2  # outside the box
    got = batched_log_prob(ct, data, "llh", len(walkers))(
        torch.as_tensor(walkers)).numpy()
    jax_value, _ = jax_ct.build_objective(
        {m.name: m.hist for m in data}, "llh")
    want = np.array([-float(jax_value(jnp.asarray(w))) for w in walkers[:3]])
    np.testing.assert_allclose(got[:3], want, rtol=1e-9)
    assert got[3] == -np.inf
