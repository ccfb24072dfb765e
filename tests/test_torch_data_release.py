"""
The port's IceCube 3-year data-release analysis against the JAX package's,
in fp64 on the CPU (conftest):

- the data and muon pipelines (``IceCube_3y_data.cfg``,
  ``IceCube_3y_muons.cfg``; ``stages/data/csv_data_hist.py``,
  ``csv_icc_hist.py``), per bin to 1e-12;
- the native daemonflux stand-in (``utils/daemonflux_native.py``): the
  correlated chi2 and the flux response, in the loop form and the
  response-basis form, to 1e-12;
- the daemonflux variant ``IceCube_3y_neutrinos_daemon.cfg`` (with the
  ``true_allsky_fine`` grid cut to 20x20, as tests/test_torch_pipeline.py
  cuts it): the eager template to 1e-10 at the nominal and two seeded
  points; its compiled correlated prior against the eager
  ``priors_penalty``; the stacked template's per-event flux route;
- the release's fit, ``DistributionMaker([neutrinos, muons])`` against the
  released counts, for both neutrino variants: the objective's value to
  ``VALUE_RTOL`` and its gradient to ``GRAD_RTOL`` (with an absolute floor
  of ``GRAD_ATOL_FRACTION`` of max|g|), as tests/test_torch_template.py
  bounds them; a short ``device`` fit through ``Analysis`` (``nit`` equal,
  best fit within 1e-6 rescaled); lanes through both pipelines against
  single calls (1e-12); ``fit_batch_on_device`` against the JAX package's on
  the same data batch.

Each JAX hypothesis is built once per module and variant, the fits are
kept to a few steps: the file's JAX compiles dominate its time.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.analysis import device_fit as jax_device_fit
from pisa_tpu.analysis.analysis import Analysis as JaxAnalysis
from pisa_tpu.analysis.gradient import (
    CompiledDistribution as JaxCompiledDistribution,
)
from pisa_tpu.config.parser import parse_pipeline_config as jax_parse
from pisa_tpu.core import binning as jax_binning
from pisa_tpu.core.distribution_maker import (
    DistributionMaker as JaxDistributionMaker,
)
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu.utils import daemonflux_native as jax_daemon
from pisa_tpu_torch import ureg as torch_ureg
from pisa_tpu_torch.analysis import device_fit
from pisa_tpu_torch.analysis.analysis import Analysis
from pisa_tpu_torch.analysis.gradient import CompiledDistribution
from pisa_tpu_torch.config.parser import parse_pipeline_config as torch_parse
from pisa_tpu_torch.core import binning as torch_binning
from pisa_tpu_torch.core.distribution_maker import DistributionMaker
from pisa_tpu_torch.core.pipeline import Pipeline as TorchPipeline
from pisa_tpu_torch.stages.osc.prob3 import prob3
from pisa_tpu_torch.stages.utils.hist import hist
from pisa_tpu_torch.utils import daemonflux_native
from pisa_tpu_torch.utils.interop import set_param_values
import test_torch_pipeline
from test_torch_template import GRAD_ATOL_FRACTION, GRAD_RTOL, VALUE_RTOL

DATA_CFG = "settings/pipeline/IceCube_3y_data.cfg"
MUON_CFG = "settings/pipeline/IceCube_3y_muons.cfg"
NEUTRINO_CFGS = {
    "daemon": "settings/pipeline/IceCube_3y_neutrinos_daemon.cfg",
    "honda_barr": "settings/pipeline/IceCube_3y_neutrinos.cfg",
}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT_RTOL = 1e-12  # the same arithmetic up to operation order
TEMPLATE_RTOL = 1e-10
FIT_X_ATOL = 1e-6  # rescaled


def _small_grid(cfg, parse, binning, ureg):
    """`cfg` parsed with its true_allsky_fine grid cut to 20x20."""
    saved = test_torch_pipeline.CFG
    test_torch_pipeline.CFG = cfg
    try:
        return test_torch_pipeline._small_grid_config(parse, binning, ureg)
    finally:
        test_torch_pipeline.CFG = saved


def _assert_maps_close(want, got, rtol):
    assert [m.name for m in got] == [m.name for m in want]
    for m in want:
        np.testing.assert_allclose(got[m.name].hist, np.asarray(m.hist),
                                   rtol=rtol, atol=0, err_msg=m.name)
        np.testing.assert_allclose(got[m.name].error_hist,
                                   np.asarray(m.error_hist), rtol=rtol,
                                   atol=0, err_msg=m.name)


def _param_values(params, names=None):
    """{name: (magnitude, unit string)} of a JAX-package ParamSet."""
    return {p.name: (float(p.value.magnitude), str(p.value.units))
            for p in params
            if (names is None or p.name in names)
            and not isinstance(p.value, str)}


@pytest.fixture(scope="module")
def data():
    """Both packages' MapSets of the released counts."""
    return (JaxPipeline(DATA_CFG).get_outputs(),
            TorchPipeline(DATA_CFG, device="cpu").get_outputs())


class _Hypotheses:
    """Both packages' ``DistributionMaker([neutrinos, muons])`` per neutrino
    variant, built on first use."""

    def __init__(self):
        self._built = {}

    def __call__(self, variant):
        if variant not in self._built:
            cfg = NEUTRINO_CFGS[variant]
            jax_dm = JaxDistributionMaker([
                _small_grid(cfg, jax_parse, jax_binning, jax_ureg), MUON_CFG])
            dm = DistributionMaker([
                _small_grid(cfg, torch_parse, torch_binning, torch_ureg),
                MUON_CFG], device="cpu")
            self._built[variant] = (jax_dm, dm)
        jax_dm, dm = self._built[variant]
        jax_dm.reset_free()
        dm.reset_free()
        return jax_dm, dm


@pytest.fixture(scope="module")
def hypotheses():
    return _Hypotheses()


@pytest.fixture(scope="module")
def daemon_pipelines():
    """Both packages' daemon neutrino pipelines on the 20x20 grid."""
    cfg = NEUTRINO_CFGS["daemon"]
    return (JaxPipeline(_small_grid(cfg, jax_parse, jax_binning, jax_ureg)),
            TorchPipeline(_small_grid(cfg, torch_parse, torch_binning,
                                      torch_ureg), device="cpu"))


def _seeded_free_values(params, seed):
    """Seeded magnitudes of the free params of a JAX ParamSet, within
    [0.1, 0.9] of their ranges: {name: (magnitude, unit string)}."""
    rng = np.random.RandomState(seed)
    free = params.free
    saved = free._rescaled_values
    try:
        free._rescaled_values = tuple(rng.uniform(0.1, 0.9, len(free)))
        return _param_values(free)
    finally:
        free._rescaled_values = saved


# -- the data and muon pipelines -------------------------------------------


def test_data_pipeline_matches(data):
    want, got = data
    assert [m.name for m in got] == ["total"]
    _assert_maps_close(want, got, EXACT_RTOL)
    assert 1e4 < got["total"].hist.sum() < 1e5


@pytest.mark.parametrize("scale", [1.0, 0.2])
def test_muon_pipeline_matches(scale):
    pipes = [JaxPipeline(MUON_CFG), TorchPipeline(MUON_CFG, device="cpu")]
    pipes[0].params["atm_muon_scale"].value = scale * jax_ureg.dimensionless
    pipes[1].params["atm_muon_scale"].value = scale * torch_ureg.dimensionless
    want, got = (p.get_outputs() for p in pipes)
    assert [m.name for m in got] == ["icc"]
    _assert_maps_close(want, got, EXACT_RTOL)
    assert got["icc"].hist.shape == (8, 8, 2)
    # the bin_unc2 the histogram leaves (the weights' histogram: no
    # uncertainty weights on this pipeline)
    unc2 = [np.asarray(p.data["icc"]["bin_unc2"]) for p in pipes]
    np.testing.assert_allclose(unc2[1], unc2[0], rtol=EXACT_RTOL, atol=0)
    np.testing.assert_allclose(unc2[1], got["icc"].hist.ravel(),
                               rtol=EXACT_RTOL, atol=0)


# -- the native daemonflux stand-in ------------------------------------------


@pytest.mark.parametrize("nubar", [1, -1])
def test_native_response_matches_jax(nubar):
    """The loop form and the response basis against the JAX package's loop
    at seeded (24,) values, over log10(E) from 0 to 3."""
    rng = np.random.RandomState(4)
    log10e = rng.uniform(0.0, 3.0, 500)
    values = dict(zip(daemonflux_native.DAEMON_PARAM_NAMES,
                      rng.normal(0.0, 1.0, 24)))
    want = [np.asarray(m) for m in jax_daemon.NativeDaemonFlux().modification(
        jnp.asarray(log10e), nubar, values)]
    native = daemonflux_native.NativeDaemonFlux()
    loop = native.modification(torch.as_tensor(log10e), nubar, values)
    basis = native.response_basis(torch.as_tensor(log10e), nubar)
    assert basis.shape == (500, 2, 24)
    v = torch.as_tensor([values[k] for k in native.param_names])
    from_basis = daemonflux_native.modification_from_basis(basis, v)
    for i in range(2):
        np.testing.assert_allclose(loop[i].numpy(), want[i],
                                   rtol=EXACT_RTOL, atol=0)
        np.testing.assert_allclose(from_basis[:, i].numpy(), want[i],
                                   rtol=EXACT_RTOL, atol=0)
    # lanes: (B, 24) values give (B, 500, 2), each lane its own product
    vb = torch.as_tensor(rng.normal(0.0, 1.0, (3, 24)))
    lanes = daemonflux_native.modification_from_basis(basis, vb)
    assert lanes.shape == (3, 500, 2)
    for b in range(3):
        single = native.modification(
            torch.as_tensor(log10e), nubar,
            dict(zip(native.param_names, vb[b])))
        np.testing.assert_allclose(lanes[b].numpy(),
                                   torch.stack(single, -1).numpy(),
                                   rtol=EXACT_RTOL, atol=0)


@pytest.mark.parametrize("correlations",
                         ["flux/daemonflux_correlations.json", None])
def test_native_chi2_matches_jax(correlations):
    rng = np.random.RandomState(6)
    want = jax_daemon.NativeDaemonFlux(correlations=correlations)
    got = daemonflux_native.NativeDaemonFlux(correlations=correlations)
    np.testing.assert_array_equal(got._cinv, np.asarray(want._cinv))
    for _ in range(3):
        v = rng.normal(0.0, 1.0, 24)
        expect = float(want.chi2(jnp.asarray(v)))
        assert got.chi2(v) == pytest.approx(expect, rel=EXACT_RTOL)
        assert float(got.chi2(torch.as_tensor(v))) == pytest.approx(
            expect, rel=EXACT_RTOL)


# -- the daemon neutrino pipeline --------------------------------------------


@pytest.mark.parametrize("point", ["nominal", "seed_0", "seed_1"])
def test_daemon_template_matches_jax(daemon_pipelines, point):
    """The eager template (the flux from the response basis) against the
    JAX package's (its loop form) at the nominal point and at two seeded
    points of all 35 free params."""
    jax_p, pipeline = daemon_pipelines
    jax_p.params.reset_free()
    pipeline.params.reset_free()
    assert len(pipeline.params.free) == 35
    values = ({} if point == "nominal"
              else _seeded_free_values(jax_p.params, int(point[-1])))
    for name, (mag, units) in values.items():
        jax_p.params[name].value = mag * jax_ureg(units)
    set_param_values(pipeline, values)
    want = jax_p.get_outputs()
    _assert_maps_close(want, pipeline.get_outputs(), TEMPLATE_RTOL)
    assert float(pipeline.params["daemon_chi2"].value.m) == pytest.approx(
        float(jax_p.params["daemon_chi2"].value.m), rel=EXACT_RTOL, abs=0)


def test_compiled_daemon_penalty_matches_eager(daemon_pipelines):
    """The compiled objective's correlated daemon prior (one chi2 over the
    daemon_* params in place of their priors) against the eager metric plus
    ``ParamSet.priors_penalty``, which reads the stage's daemon_chi2
    (tests/test_icecube_3y.py:182-210 in the JAX package)."""
    _, pipeline = daemon_pipelines
    pipeline.params.reset_free()
    ct = pipeline.compile()
    data_ms = ct.get_outputs()
    value_fn, _ = ct.build_objective(data_ms, "chi2")
    pipeline.params["daemon_K_158G"].value = 1.0 * torch_ureg.dimensionless
    pipeline.params["daemon_antiK_158G"].value = (
        -1.0 * torch_ureg.dimensionless)
    try:
        compiled = float(value_fn(ct.current_rescaled_values()))
        out = pipeline.get_outputs()
        metric = float(data_ms.metric_total(out, "chi2"))
        penalty = float(pipeline.params.priors_penalty("chi2"))
    finally:
        pipeline.params.reset_free()
    # the correlated chi2 of the pull, far from the uncorrelated 2
    assert penalty > 12.0
    assert compiled == pytest.approx(metric + penalty, rel=EXACT_RTOL)
    # without priors, none of it
    bare_fn, _ = ct.build_objective(data_ms, "chi2", priors=False)
    pipeline.params["daemon_K_158G"].value = 1.0 * torch_ureg.dimensionless
    pipeline.params["daemon_antiK_158G"].value = (
        -1.0 * torch_ureg.dimensionless)
    try:
        bare = float(bare_fn(ct.current_rescaled_values()))
    finally:
        pipeline.params.reset_free()
    assert bare == pytest.approx(metric, rel=EXACT_RTOL)


def test_detectors_objective_takes_the_daemon_prior(daemon_pipelines, data):
    """CompiledDetectors' joint prior (over every detector's pipelines)
    switches to the correlated daemon chi2 as CompiledDistribution's does:
    one detector of the daemon pipeline gives the same value and gradient
    at a pulled point, with and without priors."""
    from pisa_tpu_torch.analysis.gradient import CompiledDetectors
    from pisa_tpu_torch.core.detectors import Detectors

    _, pipeline = daemon_pipelines
    pipeline.params.reset_free()
    cd = CompiledDistribution(pipeline)
    cdet = CompiledDetectors(Detectors([pipeline], device="cpu"))
    assert cdet.free_names == cd.free_names
    x = cd.current_rescaled_values()
    for name in ("daemon_K_158G", "daemon_antiK_158G", "daemon_pi_31G"):
        x[cd.free_names.index(name)] += 0.1
    for priors in (True, False):
        want_v, want_g = cd.build_objective(data[1], "mod_chi2",
                                            priors=priors)[1](x)
        value, grad = cdet.build_objective([data[1]], "mod_chi2",
                                           priors=priors)[1](x)
        assert float(value) == pytest.approx(float(want_v), rel=EXACT_RTOL)
        np.testing.assert_allclose(grad.numpy(), want_g.numpy(), rtol=0,
                                   atol=EXACT_RTOL * want_g.abs().max())
        if priors:
            with_priors = float(value)
    # the difference is the daemon params' correlated chi2 (the others sit
    # at their priors' means)
    los, his = cd._current_bounds()
    mags = dict(zip(cd.free_names, los + (his - los) * x))
    v = [mags["daemon_" + n] for n in daemonflux_native.DAEMON_PARAM_NAMES]
    assert with_priors - float(value) == pytest.approx(
        pipeline.stages[1].native.chi2(v), rel=1e-9)


def test_stacked_daemon_takes_the_per_event_branch(daemon_pipelines,
                                                   monkeypatch):
    """Stacked, the oscillation stage finds the flux valid per event and
    takes the per-event product, so no grid rate reaches the histogram:
    the template declines the factorized histogram and builds no S and
    S2. Its output equals the eager (per container) template."""
    _, pipeline = daemon_pipelines
    pipeline.params.reset_free()
    eager = pipeline.get_outputs()
    routes = []
    apply_stacked = prob3._apply_stacked

    def spy(self, container):
        routes.append(container.validity["nu_flux"].get(hash("events"),
                                                        False))
        apply_stacked(self, container)
        routes.append(container.deferred_rate)

    def refuse(self, container, dr):
        raise AssertionError("a deferred rate reached the histogram")

    monkeypatch.setattr(prob3, "_apply_stacked", spy)
    monkeypatch.setattr(hist, "_apply_stacked_deferred", refuse)
    ct = pipeline.compile()
    assert ct.stacked and not ct.rate_deferred
    assert all(c.rate_defer is None for c in ct._trace_data.containers)
    _assert_maps_close(eager, ct.get_outputs(), EXACT_RTOL)
    assert routes == [True, None]


# -- the three-pipeline fit to the released counts ---------------------------


@pytest.mark.parametrize("metric", ["mod_chi2", "llh"])
@pytest.mark.parametrize("variant", ["daemon", "honda_barr"])
def test_release_objective_matches(hypotheses, data, variant, metric):
    """Value and gradient of the objective of neutrinos + muons against
    the released counts, at the nominal point and at a seeded one."""
    jax_dm, dm = hypotheses(variant)
    jax_cd = JaxCompiledDistribution(jax_dm)
    cd = CompiledDistribution(dm)
    assert cd.free_names == jax_cd.free_names
    assert len(cd.free_names) == {"daemon": 36, "honda_barr": 16}[variant]
    assert cd.free_names[-1] == "atm_muon_scale"
    assert cd.templates[0].stacked and not cd.templates[1].stacked
    assert cd.templates[0].rate_deferred == (variant == "honda_barr")
    _, jax_vg = jax_cd.build_objective(data[0], metric)
    _, vg = cd.build_objective(data[1], metric)
    x0 = np.clip(cd.current_rescaled_values(), 0.15, 0.85)
    rng = np.random.RandomState(3)
    for x in (x0, np.clip(x0 + rng.uniform(-0.1, 0.1, x0.size), 0.05, 0.95)):
        want_v, want_g = (np.asarray(a) for a in jax_vg(x))
        value, grad = vg(x)
        assert float(value) == pytest.approx(float(want_v), rel=VALUE_RTOL)
        np.testing.assert_allclose(
            grad.numpy(), want_g, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_FRACTION * np.abs(want_g).max())


def test_device_fit_to_the_released_counts(hypotheses, data):
    """method 'device' through Analysis on the daemon hypothesis: the same
    iterations as the JAX package's fit, best fits within 1e-6."""
    jax_dm, dm = hypotheses("daemon")
    results = [
        analysis().fit_recursively(d, maker, "mod_chi2", None, "device",
                                   {"max_steps": 4}, None)
        for analysis, d, maker in ((JaxAnalysis, data[0], jax_dm),
                                   (Analysis, data[1], dm))]
    jax_result, result = results
    assert result.minimizer_metadata["nit"] == (
        jax_result.minimizer_metadata["nit"]) == 4
    x = [np.asarray(r.params.free._rescaled_values) for r in results]
    np.testing.assert_allclose(x[1], x[0], rtol=0, atol=FIT_X_ATOL)
    assert result.metric_val == pytest.approx(jax_result.metric_val,
                                              rel=1e-9)
    assert result.metric_val < 371.0


def test_gradient_and_scipy_fits_to_the_released_counts(hypotheses, data):
    """Analysis.fit_hypo with the methods 'gradient' and 'scipy' (scipy's
    L-BFGS-B on the analytic gradient, 3 iterations) on the hypothesis of
    the JAX example (IceCube_3y_neutrinos.cfg + muons): the port's
    'gradient' fit equals the JAX package's, and 'scipy' takes the same
    route."""
    settings = {"method": "gradient",
                "method_kwargs": {"options": {"maxiter": 3}}}
    jax_dm, dm = hypotheses("honda_barr")
    jax_result, _ = JaxAnalysis().fit_hypo(data[0], jax_dm, "mod_chi2",
                                           minimizer_settings=settings)
    results = {}
    for method in ("gradient", "scipy"):
        dm.reset_free()
        results[method], _ = Analysis().fit_hypo(
            data[1], dm, "mod_chi2",
            minimizer_settings=dict(settings, method=method))
    x = {k: np.asarray(r.params.free._rescaled_values)
         for k, r in results.items()}
    np.testing.assert_allclose(
        x["gradient"], np.asarray(jax_result.params.free._rescaled_values),
        rtol=0, atol=FIT_X_ATOL)
    assert results["gradient"].metric_val == pytest.approx(
        jax_result.metric_val, rel=1e-9)
    np.testing.assert_array_equal(x["scipy"], x["gradient"])
    assert results["scipy"].metric_val < 371.0


def test_fits_reuse_one_compiled_distribution(hypotheses, data):
    """daemon_chi2 is a fixed param that every eager evaluation rewrites
    (the stage's covariance chi2): it is no input of the compiled
    objective, so a second fit (after the first's eager best-fit
    template) reuses the first fit's CompiledDistribution and its captured
    programs instead of building another."""
    from pisa_tpu_torch.analysis.analysis import BasicAnalysis

    _, dm = hypotheses("daemon")
    BasicAnalysis._compiled_cache.clear()
    try:
        first = BasicAnalysis()._get_compiled(dm)
        chi2 = dm.params["daemon_chi2"].value
        dm.params["daemon_pi_31G"].value = 1.0 * torch_ureg.dimensionless
        dm.get_outputs(return_sum=True)
        assert dm.params["daemon_chi2"].value != chi2
        dm.reset_free()
        assert BasicAnalysis()._get_compiled(dm) is first
        # a fixed input param still gives another one
        dm.params["daemon_pi_31G"].is_fixed = True
        dm.params["daemon_pi_31G"].value = 0.5 * torch_ureg.dimensionless
        assert BasicAnalysis()._get_compiled(dm) is not first
    finally:
        dm.params["daemon_pi_31G"].is_fixed = False
        dm.reset_free()
        BasicAnalysis._compiled_cache.clear()


def test_lanes_through_both_pipelines(hypotheses, data):
    """raw_with_data over 4 lanes (one stacked and one per-container
    pipeline) equals 4 single calls, value and gradient, with the released
    counts closed over and with per-lane data."""
    _, dm = hypotheses("daemon")
    cd = CompiledDistribution(dm)
    los, his = cd._device_bounds()
    value_fn, _ = cd.build_objective(data[1], "mod_chi2")
    rng = np.random.RandomState(8)
    x0 = cd.current_rescaled_values()
    x = np.clip(x0 + rng.uniform(-0.1, 0.1, (4, x0.size)), 0.05, 0.95)
    counts = rng.poisson(np.clip(cd.sum_hist(x0), 0, None), (4, 128))
    for lane_data in (None, torch.as_tensor(counts, dtype=torch.float64)):
        vec = torch.tensor(x, requires_grad=True)
        values = value_fn.raw_with_data(vec, los, his, lane_data)
        assert values.shape == (4,)
        values.sum().backward()
        for b in range(4):
            # a lane's own data keeps the closed-over variance
            single_fn = value_fn if lane_data is None else cd.build_objective(
                counts[b].astype(np.float64), "mod_chi2",
                data_variance=data[1]["total"].variance)[0]
            v = torch.tensor(x[b], requires_grad=True)
            value = single_fn.raw(v, los, his)
            value.backward()
            assert float(values[b].detach()) == pytest.approx(
                float(value.detach()), rel=EXACT_RTOL)
            np.testing.assert_allclose(
                vec.grad[b].numpy(), v.grad.numpy(), rtol=0,
                atol=EXACT_RTOL * v.grad.abs().max().item())


def test_batch_fit_matches_jax(hypotheses, data):
    """fit_batch_on_device on the daemon hypothesis with the same Poisson
    data batch and starts in both packages: nit equal, x within 1e-8."""
    jax_dm, dm = hypotheses("daemon")
    jax_cd = JaxCompiledDistribution(jax_dm)
    cd = CompiledDistribution(dm)
    x_nom = cd.current_rescaled_values()
    rng = np.random.RandomState(12)
    counts = rng.poisson(np.clip(cd.sum_hist(x_nom), 0, None),
                         (2, 128)).astype(np.float64)
    x0 = np.clip(x_nom + rng.uniform(-0.05, 0.05, (2, x_nom.size)),
                 0.02, 0.98)
    los, his = jax_cd._current_bounds()
    jax_value_fn, _ = jax_cd.build_objective(data[0], "mod_chi2")
    want = [np.asarray(a) for a in jax_device_fit.fit_batch_on_device(
        jax_value_fn.raw_with_data, x0, los, his, jax_cd._all_data_vals(),
        counts, max_steps=3)]
    value_fn, _ = cd.build_objective(data[1], "mod_chi2")
    got = [a.numpy() for a in device_fit.fit_batch_on_device(
        value_fn.raw_with_data, x0, *cd._current_bounds(), counts,
        max_steps=3, device="cpu")]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-8)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-9)


def test_float32_release_hypothesis_and_imports():
    """In float32 (the port's default; the suite runs float64), the release
    hypothesis evaluates in float32 data, single and with lanes, and
    importing its stages pulls in neither jax nor pandas."""
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from pisa_tpu_torch import TORCH_FTYPE, ureg\n"
        "from pisa_tpu_torch.analysis.gradient import CompiledDistribution\n"
        "from pisa_tpu_torch.config.parser import parse_pipeline_config\n"
        "from pisa_tpu_torch.core import binning\n"
        "from pisa_tpu_torch.core.distribution_maker import"
        " DistributionMaker\n"
        "from pisa_tpu_torch.core.pipeline import Pipeline\n"
        f"config = parse_pipeline_config({NEUTRINO_CFGS['daemon']!r})\n"
        "grid = binning.MultiDimBinning([binning.OneDimBinning("
        "'true_energy', num_bins=20, is_log=True, domain=[1, 1000] *"
        " ureg.GeV), binning.OneDimBinning('true_coszen', num_bins=20,"
        " is_lin=True, domain=[-1, 1])], name='true_allsky_fine')\n"
        "for key, settings in config.items():\n"
        "    for mode in ('calc_mode', 'apply_mode'):\n"
        "        if isinstance(key, tuple) and getattr(settings.get(mode),"
        " 'name', None) == grid.name:\n"
        "            settings[mode] = grid\n"
        f"hm = DistributionMaker([config, {MUON_CFG!r}], device='cpu')\n"
        f"data = Pipeline({DATA_CFG!r}, device='cpu').get_outputs()\n"
        "cd = CompiledDistribution(hm)\n"
        "value_fn, vg = cd.build_objective(data, 'mod_chi2')\n"
        "v = cd.current_rescaled_values()\n"
        "value, grad = vg(v)\n"
        "lanes = value_fn.raw_with_data(torch.as_tensor(np.tile(v, (2, 1))),"
        " *cd._device_bounds())\n"
        "flux = cd.templates[0]._trace_data.containers[0]\n"
        "flux.representation = 'events'\n"
        "ok = (TORCH_FTYPE == torch.float32"
        " and flux['daemon_response'].dtype == torch.float32"
        " and bool(torch.isfinite(grad).all())"
        " and abs(float(lanes[1]) - float(value)) <= 1e-5 * float(value))\n"
        "bad = [m for m in ('jax', 'pisa_tpu', 'pandas') if m in sys.modules]\n"
        "print(float(value), lanes.tolist(), bad)\n"
        "sys.exit(0 if ok and not bad else 1)\n"
    )
    env = dict(os.environ, PISA_TPU_FTYPE="fp32")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_card_release_objective_matches_cpu(cuda_device, hypotheses, data):
    """The daemon hypothesis captured on the card (one program over both
    pipelines) against the CPU run, value and gradient in fp64."""
    _, dm = hypotheses("daemon")
    cd = CompiledDistribution(dm)
    card = CompiledDistribution(DistributionMaker([
        _small_grid(NEUTRINO_CFGS["daemon"], torch_parse, torch_binning,
                    torch_ureg), MUON_CFG], device=cuda_device))
    assert card.capture
    x = np.clip(cd.current_rescaled_values(), 0.15, 0.85)
    want_v, want_g = cd.build_objective(data[1], "mod_chi2")[1](x)
    value, grad = card.build_objective(data[1], "mod_chi2")[1](x)
    assert float(value) == pytest.approx(float(want_v), rel=VALUE_RTOL)
    np.testing.assert_allclose(grad.cpu().numpy(), want_g.numpy(),
                               rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_FRACTION * want_g.abs().max())
