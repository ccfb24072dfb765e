"""
The port's batched fits (``pisa_tpu_torch.analysis.device_fit.
fit_batch_on_device`` and ``fit_pseudo_ensemble``, over the batched
objective ``value_fn.raw_with_data``) against the JAX package's vmapped
L-BFGS (``pisa_tpu/analysis/device_fit.py:192-297``), in fp64 on the CPU.

- Closed-form objectives: the multi-start and per-lane-data quadratics of
  ``tests/test_device_fit.py`` against JAX's batch, and lanes that stop at
  different iterations and zoom at different line-search steps against
  each lane's solo ``lbfgs_while``: ``nit`` equal, ``x`` within 1e-12.
- ``toy_flux_fit.cfg`` (two_nu_osc) and ``toy_fit_example.cfg`` (prob3,
  through the chain kernels' plain versions): both packages'
  ``fit_batch_on_device`` on the same seeded data batch: ``nit`` equal,
  ``x`` within 1e-8. Each JAX batch fit runs once per module.
- The batched objective on the 20x20-grid flagship: each lane's value and
  gradient against the single-lane objective, 1e-12 relative.
- ``fit_pseudo_ensemble`` on ``toy_flux_fit.cfg`` as
  ``tests/test_device_fit.py:162-184`` checks it, and the ``two_nu_osc``
  template against the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.analysis import device_fit as jax_device_fit
from pisa_tpu.analysis.gradient import (
    CompiledDistribution as JaxCompiledDistribution,
)
from pisa_tpu.core.distribution_maker import (
    DistributionMaker as JaxDistributionMaker,
)
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu_torch import ureg
from pisa_tpu_torch.analysis import device_fit
from pisa_tpu_torch.analysis.gradient import CompiledDistribution
from pisa_tpu_torch.config.parser import parse_pipeline_config
from pisa_tpu_torch.core import binning
from pisa_tpu_torch.core.distribution_maker import DistributionMaker
from pisa_tpu_torch.core.pipeline import Pipeline
from test_torch_pipeline import _small_grid_config

TOY_FLUX = "settings/pipeline/toy_flux_fit.cfg"
TOY_FIT = "settings/pipeline/toy_fit_example.cfg"


# -- closed-form objectives ------------------------------------------------------
def _quad_with_data(xp):
    """sum (x - target)^2, the target (0.3, 0.7) or each lane's data."""
    def fn(vec, los, his, *rest):
        data = rest[-1] if rest else None
        if xp is jnp:
            target = jnp.asarray([0.3, 0.7]) if data is None else data
            return jnp.sum((vec - target) ** 2)
        target = (torch.tensor([0.3, 0.7], dtype=vec.dtype) if data is None
                  else data)
        return ((vec - target) ** 2).sum(-1)
    return fn


def _rosenbrock(x, los=None, his=None, data=None):
    """Rosenbrock in 5-D (minimum at x = 2/3), lane by lane."""
    y = 3.0 * x - 1.0
    total = 1.0
    for i in range(y.shape[-1] - 1):
        total = total + 100.0 * (y[..., i + 1] - y[..., i] ** 2) ** 2 + (
            1.0 - y[..., i]) ** 2
    return total


def _nan_beyond(x, los=None, his=None, data=None):
    """NaN for x[0] > 0.9 (the guard turns it into 1e30)."""
    value = ((x - 0.5) ** 2).sum(-1) + 1.0
    return torch.where(x[..., 0] > 0.9, torch.full_like(value, float("nan")),
                       value)


@pytest.mark.parametrize("case", ["multistart", "per_lane_data"])
def test_quadratic_batch_matches_jax(case):
    """The quadratics of tests/test_device_fit.py:52-75 in both packages'
    fit_batch_on_device: the same minima, and each lane's nit and x equal
    to JAX's (x within 1e-12)."""
    if case == "multistart":
        x0s = np.array([[0.1, 0.1], [0.9, 0.9], [0.5, 0.2]])
        data = None
        targets = np.tile([0.3, 0.7], (3, 1))
    else:
        x0s = np.full((2, 2), 0.5)
        data = targets = np.array([[0.2, 0.8], [0.6, 0.4]])
    want = jax_device_fit.fit_batch_on_device(
        _quad_with_data(jnp), x0s, np.zeros(2), np.ones(2), None, data)
    xb, fb, nb = device_fit.fit_batch_on_device(
        _quad_with_data(torch), x0s, np.zeros(2), np.ones(2), data,
        device="cpu")
    assert xb.shape == x0s.shape and fb.shape == nb.shape == (len(x0s),)
    np.testing.assert_allclose(xb.numpy(), targets,
                               atol=device_fit.DEFAULT_GTOL)
    assert np.all(fb.numpy() < 1e-8)
    np.testing.assert_array_equal(nb.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(xb.numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-12)


# lanes of one batch: starts whose fits stop at different iterations
LANE_CASES = {
    "rosenbrock_5d": (_rosenbrock, [
        [0.1, 0.8, 0.3, 0.6, 0.2], [0.9, 0.1, 0.5, 0.5, 0.5],
        [0.4, 0.4, 0.4, 0.4, 0.4], [0.2, 0.3, 0.7, 0.1, 0.9],
    ]),
    "guard": (_nan_beyond, [[0.2, 0.4], [0.95, 0.4], [0.6, 0.1]]),
}


@pytest.mark.parametrize("case", list(LANE_CASES))
def test_lanes_equal_solo_fits(case, monkeypatch):
    """Every lane of a batched lbfgs_while is its solo fit: nit equal, x
    and the value within 1e-12, although the lanes stop at different
    iterations and, within an iteration, switch from the interval search
    to the zoom at different line-search steps (seen in the phase masks
    the line search is given)."""
    fun, starts = LANE_CASES[case]
    z0 = device_fit._to_z(np.asarray(starts), "cpu")
    phases = []
    step = device_fit._LineSearch.step

    def recording_step(self, s, zoom, active=None):
        if isinstance(zoom, torch.Tensor):
            phases.append((zoom & active).any() and (~zoom & active).any())
        return step(self, s, zoom, active)

    monkeypatch.setattr(device_fit._LineSearch, "step", recording_step)
    z, value, nit, nfev, reads = device_fit.lbfgs_while(
        lambda z: fun(torch.sigmoid(z)), z0)
    assert reads == nfev - 1
    solo = [device_fit.lbfgs_while(lambda z: fun(torch.sigmoid(z)), z0[b])
            for b in range(len(starts))]
    assert [int(n) for n in nit] == [s[2] for s in solo]
    for b, (zb, vb, _, _, _) in enumerate(solo):
        np.testing.assert_allclose(torch.sigmoid(z[b]).numpy(),
                                   torch.sigmoid(zb).numpy(), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(float(value[b]), float(vb), rtol=1e-12)
    if case == "rosenbrock_5d":
        assert len(set(int(n) for n in nit)) > 1
        assert any(bool(p) for p in phases)  # mixed phases in one step


# -- pipelines ------------------------------------------------------------------
TOY_FLUX_TRUTH = {"delta_index": 0.0, "theta23": 0.85, "aeff_scale": 1.2}
TOY_FIT_TRUTH = {"delta_index": 0.03, "theta23": 45.0 * jax_ureg.degree,
                 "aeff_scale": 1.1}


def _set_values(maker, values, unit_registry):
    for name, value in values.items():
        if hasattr(value, "units"):
            value = unit_registry.Quantity(value.magnitude, str(value.units))
        maker.params[name].value = value


def _batch_inputs(cfg, truth, n_lanes, seed):
    """Both packages' compiled distributions at `truth`, the JAX Asimov
    template there, seeded Poisson data lanes of it, and starts around the
    nominal values (seeded): the JAX objective's inputs and the port's."""
    jax_dm = JaxDistributionMaker([cfg])
    _set_values(jax_dm, truth, jax_ureg)
    jax_cd = JaxCompiledDistribution(jax_dm)
    asimov = np.asarray(jax_cd.sum_hist(jax_cd.current_rescaled_values()))
    jax_dm.reset_free()
    jax_cd = JaxCompiledDistribution(jax_dm)

    dm = DistributionMaker([cfg], device="cpu")
    cd = CompiledDistribution(dm)
    assert cd.free_names == jax_cd.free_names
    rng = np.random.RandomState(seed)
    data = rng.poisson(np.clip(asimov, 0, None), (n_lanes, asimov.size))
    x_nom = np.asarray(jax_cd.current_rescaled_values())
    np.testing.assert_allclose(cd.current_rescaled_values(), x_nom,
                               rtol=1e-12)
    x0 = np.clip(x_nom + rng.uniform(-0.05, 0.05, (n_lanes, x_nom.size)),
                 0.02, 0.98)
    return jax_cd, cd, asimov, data.astype(np.float64), x0


def _both_batch_fits(cfg, truth, n_lanes, seed, max_steps):
    jax_cd, cd, asimov, data, x0 = _batch_inputs(cfg, truth, n_lanes, seed)
    los, his = jax_cd._current_bounds()
    value_fn, _ = jax_cd.build_objective(asimov, "llh")
    want = jax_device_fit.fit_batch_on_device(
        value_fn.raw_with_data, x0, los, his, jax_cd._all_data_vals(),
        data, max_steps=max_steps)
    value_fn, _ = cd.build_objective(asimov, "llh")
    got = device_fit.fit_batch_on_device(
        value_fn.raw_with_data, x0, *cd._current_bounds(), data,
        max_steps=max_steps, device="cpu")
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.fixture(scope="module")
def toy_flux_batch():
    return _both_batch_fits(TOY_FLUX, TOY_FLUX_TRUTH, 8, 7, 100)


@pytest.fixture(scope="module")
def toy_fit_batch():
    return _both_batch_fits(TOY_FIT, TOY_FIT_TRUTH, 3, 11, 10)


@pytest.mark.parametrize("config", ["toy_flux_fit", "toy_fit_example"])
def test_batch_fit_matches_jax(config, request):
    """The port's fit_batch_on_device against the JAX package's on the same
    data lanes from the same starts: nit equal, x within 1e-8 rescaled,
    fun within 1e-9 relative (fp64; prob3 through the chain kernels' plain
    versions, JAX through its XLA route)."""
    fixture = {"toy_flux_fit": "toy_flux_batch",
               "toy_fit_example": "toy_fit_batch"}[config]
    (want_x, want_f, want_n), (got_x, got_f, got_n) = (
        request.getfixturevalue(fixture))
    assert got_x.shape == want_x.shape
    np.testing.assert_array_equal(got_n, want_n)
    assert np.all(got_n > 0)
    np.testing.assert_allclose(got_x, want_x, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got_f, want_f, rtol=1e-9)


@pytest.fixture(scope="module")
def flagship_objective():
    ct_pipeline = Pipeline(
        _small_grid_config(parse_pipeline_config, binning, ureg),
        device="cpu")
    cd = CompiledDistribution(ct_pipeline)
    x0 = cd.current_rescaled_values()
    asimov = cd.sum_hist(x0)
    rng = np.random.RandomState(2)
    x = np.clip(x0 + rng.uniform(-0.1, 0.1, (3, x0.size)), 0.01, 0.99)
    data = rng.poisson(np.clip(asimov, 0, None), (3, asimov.size))
    return cd, asimov, x, data.astype(np.float64)


@pytest.mark.parametrize("metric", ["llh", "mod_chi2"])
def test_batched_objective_matches_single(flagship_objective, metric):
    """raw_with_data on the 20x20-grid flagship (stacked, rate deferral):
    each lane's value and gradient equal the single-lane objective's with
    that lane's data (1e-12 relative), and data=None gives each lane the
    closed-over data's value."""
    cd, asimov, x, data = flagship_objective
    los, his = cd._device_bounds()
    value_fn, _ = cd.build_objective(asimov, metric)
    vec = torch.tensor(x, requires_grad=True)
    values = value_fn.raw_with_data(vec, los, his, torch.tensor(data))
    assert values.shape == (3,)
    values.sum().backward()
    closed = value_fn.raw_with_data(torch.tensor(x), los, his, None)
    for b in range(3):
        single_fn, _ = cd.build_objective(data[b], metric)
        v = torch.tensor(x[b], requires_grad=True)
        value = single_fn.raw(v, los, his)
        value.backward()
        np.testing.assert_allclose(float(values[b].detach()), float(value.detach()),
                                   rtol=1e-12)
        scale = float(v.grad.abs().max())
        assert float((vec.grad[b] - v.grad).abs().max()) <= 1e-12 * scale
        np.testing.assert_allclose(
            float(closed[b]), float(value_fn.raw(torch.tensor(x[b]), los,
                                                 his)), rtol=1e-12)


def test_batched_objective_rejects_bad_lanes(flagship_objective):
    cd, asimov, x, data = flagship_objective
    los, his = cd._device_bounds()
    value_fn, _ = cd.build_objective(asimov, "llh")
    with pytest.raises(ValueError, match="lanes"):
        value_fn.raw_with_data(torch.tensor(x[0]), los, his, None)
    with pytest.raises(ValueError, match="data"):
        value_fn.raw_with_data(torch.tensor(x), los, his,
                               torch.tensor(data[:2]))


def test_bound_objective(flagship_objective):
    """raw_with_data.bind(data, B) is raw_with_data with that data: the same
    values and gradients; it takes B lanes only."""
    cd, asimov, x, data = flagship_objective
    los, his = cd._device_bounds()
    value_fn, _ = cd.build_objective(asimov, "llh")
    for d in (torch.tensor(data), None):
        want_vec = torch.tensor(x, requires_grad=True)
        want = value_fn.raw_with_data(want_vec, los, his, d)
        want.sum().backward()
        bound = value_fn.raw_with_data.bind(d, 3)
        got_vec = torch.tensor(x, requires_grad=True)
        got = bound(got_vec, los, his)
        got.sum().backward()
        np.testing.assert_array_equal(got.detach().numpy(),
                                      want.detach().numpy())
        np.testing.assert_array_equal(got_vec.grad.numpy(),
                                      want_vec.grad.numpy())
        with pytest.raises(ValueError, match="bound for 3 lanes"):
            bound(torch.tensor(x[:2]), los, his)


@pytest.fixture(scope="module")
def toy_flux_ensemble():
    dm = DistributionMaker([TOY_FLUX], device="cpu")
    _set_values(dm, TOY_FLUX_TRUTH, ureg)
    cd = CompiledDistribution(dm)
    ens = device_fit.fit_pseudo_ensemble(cd, "llh", n_trials=16, seed=3,
                                         max_steps=60)
    return cd, ens


def test_pseudo_ensemble(toy_flux_ensemble):
    """As tests/test_device_fit.py:162-184 checks the JAX package's: shapes,
    finite fits, aeff_scale unbiased within 0.1 with a spread in (0, 0.5),
    every trial's data distinct; the magnitudes are the rescaled values
    mapped to physical units."""
    cd, ens = toy_flux_ensemble
    assert ens["x"].shape == ens["magnitudes"].shape == (16, 3)
    assert ens["fun"].shape == ens["nit"].shape == (16,)
    assert np.all(np.isfinite(ens["fun"])) and np.all(ens["nit"] > 0)
    assert ens["reads"] == ens["nfev"] - 1
    i_a = ens["free_names"].index("aeff_scale")
    fits = ens["magnitudes"][:, i_a]
    assert abs(np.mean(fits) - TOY_FLUX_TRUTH["aeff_scale"]) < 0.1, fits
    assert 0.0 < np.std(fits) < 0.5
    assert len({d.tobytes() for d in ens["data"]}) == 16
    los, his = cd._current_bounds()
    np.testing.assert_allclose(ens["magnitudes"][:, i_a],
                               los[i_a] + (his[i_a] - los[i_a])
                               * ens["x"][:, i_a], rtol=1e-12)


def test_pseudo_ensemble_seeded(toy_flux_ensemble):
    """The same seed draws the same data, another seed other data."""
    cd, ens = toy_flux_ensemble
    again = device_fit.fit_pseudo_ensemble(cd, "llh", n_trials=16, seed=3,
                                           max_steps=1)
    other = device_fit.fit_pseudo_ensemble(cd, "llh", n_trials=16, seed=4,
                                           max_steps=1)
    np.testing.assert_array_equal(again["data"], ens["data"])
    assert not np.array_equal(other["data"], ens["data"])


@pytest.mark.parametrize("point", ["nominal", "moved"])
def test_two_nu_osc_template_matches_jax(point):
    """The toy_flux_fit pipeline (toy events, barr_simple, two_nu_osc,
    aeff) in both packages: the same maps to 1e-12 relative (fp64)."""
    jax_p = JaxPipeline(TOY_FLUX)
    torch_p = Pipeline(TOY_FLUX, device="cpu")
    if point == "moved":
        for p, units in ((jax_p, jax_ureg), (torch_p, ureg)):
            p.params["theta23"].value = 0.7 * units.dimensionless
            p.params["deltam31"].value = 3.1e-3 * units.eV**2
            p.params["delta_index"].value = 0.05 * units.dimensionless
    want = jax_p.get_outputs()
    got = torch_p.get_outputs()
    assert [m.name for m in got] == [m.name for m in want]
    for jm in want:
        hist = got[jm.name].hist
        assert np.all(np.isfinite(hist))
        np.testing.assert_allclose(hist, np.asarray(jm.hist), rtol=1e-12,
                                   atol=0, err_msg=jm.name)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_captured_batched_objective_on_card(cuda_device):
    """raw_with_data on the card (the 20x20-grid flagship, fp64): one
    captured program per lane count, whose values and gradients equal the
    eager batched objective's on the same card (1e-12 relative), whose
    eager value_and_grad launches 2 primal and 2 multitangent kernels for
    3 lanes as for one, and which, bound to a data batch, copies it in once."""
    from pisa_tpu_torch.ops.osc import chain

    cd = CompiledDistribution(Pipeline(
        _small_grid_config(parse_pipeline_config, binning, ureg),
        device=cuda_device))
    x0 = cd.current_rescaled_values()
    asimov = cd.sum_hist(x0)
    rng = np.random.RandomState(4)
    x = torch.as_tensor(
        np.clip(x0 + rng.uniform(-0.1, 0.1, (3, x0.size)), 0.01, 0.99),
        device=cuda_device)
    data = torch.as_tensor(
        rng.poisson(np.clip(asimov, 0, None), (3, asimov.size)),
        dtype=torch.float64, device=cuda_device)
    los, his = cd._device_bounds()
    value_fn, _ = cd.build_objective(asimov, "llh")
    eager = cd._objective(asimov, "llh")
    for lanes in (1, 3):
        v = x[:lanes].clone().requires_grad_(True)
        before = (chain.launch_count, chain.multitangent_launch_count)
        want = eager(v, los, his, data[:lanes])
        want.sum().backward()
        torch.cuda.synchronize()
        assert (chain.launch_count - before[0],
                chain.multitangent_launch_count - before[1]) == (2, 2)
        got = x[:lanes].clone().requires_grad_(True)
        d = data[:lanes].contiguous()
        value = value_fn.raw_with_data(got, los, his, d)
        value.sum().backward()
        np.testing.assert_allclose(value.detach().cpu().numpy(),
                                   want.detach().cpu().numpy(), rtol=1e-12)
        scale = float(v.grad.abs().max())
        assert float((got.grad - v.grad).abs().max()) <= 1e-12 * scale
        # bound, the data is copied into the program once, at the bind
        bound = value_fn.raw_with_data.bind(d, lanes)
        program = value_fn.raw_with_data.programs[(lanes, True)]
        assert torch.equal(program._static[3], d)
        d.mul_(2.0)
        with torch.no_grad():
            again = bound(x[:lanes], los, his)
        np.testing.assert_array_equal(again.cpu().numpy(),
                                      value.detach().cpu().numpy())
