"""
The port's analysis layer (``pisa_tpu_torch.core.distribution_maker``,
``analysis/gradient.py:CompiledDistribution``, ``analysis/analysis.py``)
against the JAX package's, on ``settings/pipeline/toy_fit_example.cfg`` (the
config of tests/test_analysis.py) in fp64 on the CPU: the same Asimov data
(theta23 = 42 deg, delta_index = 0), the same start (theta23 = 39 deg), each
fit method and strategy run through both packages' ``Analysis``.

Tolerances: templates and objectives differ only in operation order
(1e-9 relative per bin and for the value, 1e-7 of max|g| for the gradient);
the fits follow the same iterations (``nit`` and ``nfev`` equal) to best
fits within 1e-6 rescaled; SLSQP from the settings file within 1e-6
relative in the metric and 1e-4 rescaled; Hesse errors within 1e-4.

Each fit costs tens of seconds on the CPU (the plain tangents of the
oscillation kernels), so each runs once, in one test.
"""

import numpy as np
import pytest
import torch

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.analysis.analysis import Analysis as JaxAnalysis
from pisa_tpu.analysis.gradient import CompiledDistribution as JaxCompiled
from pisa_tpu.core.distribution_maker import (
    DistributionMaker as JaxDistributionMaker,
)
from pisa_tpu_torch import ureg
from pisa_tpu_torch.analysis.analysis import Analysis, BasicAnalysis
from pisa_tpu_torch.analysis.analysis import HypoFitResult
from pisa_tpu_torch.analysis.gradient import CompiledDistribution
from pisa_tpu_torch.core.distribution_maker import DistributionMaker

CFG = "settings/pipeline/toy_fit_example.cfg"
TRUTH = {"theta23": 42.0, "delta_index": 0.0}
START = 39.0  # theta23, degrees
VALUE_RTOL = 1e-9
GRAD_ATOL_FRACTION = 1e-7  # of max |gradient|
FIT_X_ATOL = 1e-6  # rescaled


class Side:
    """One package's hypo maker, its Asimov data and its Analysis."""

    def __init__(self, dm, ureg_, analysis):
        self.dm, self.ureg, self.analysis = dm, ureg_, analysis
        dm.params["theta23"].value = TRUTH["theta23"] * ureg_.degree
        dm.params["delta_index"].value = TRUTH["delta_index"]
        self.data = dm.get_outputs(return_sum=True)
        dm.reset_free()

    def start(self, theta23=START):
        self.dm.reset_free()
        self.dm.params["theta23"].value = theta23 * self.ureg.degree

    def fit(self, method, method_kwargs=None, local_fit_kwargs=None,
            metric="mod_chi2"):
        self.start()
        return self.analysis().fit_recursively(
            self.data, self.dm, metric, None, method,
            method_kwargs(self.ureg) if callable(method_kwargs)
            else method_kwargs or {},
            local_fit_kwargs,
        )


@pytest.fixture(scope="module")
def sides():
    jax_side = Side(JaxDistributionMaker([CFG], label="toy"), jax_ureg,
                    JaxAnalysis)
    port_side = Side(DistributionMaker([CFG], label="toy", device="cpu"),
                     ureg, Analysis)
    return jax_side, port_side


def _x(result):
    return np.asarray(result.params.free._rescaled_values, dtype=np.float64)


def _same_fit(jax_result, port_result, x_atol=FIT_X_ATOL):
    assert port_result.params.free.names == jax_result.params.free.names
    np.testing.assert_allclose(_x(port_result), _x(jax_result), rtol=0,
                               atol=x_atol)


def test_free_params_and_distribution_match(sides):
    jax_side, port_side = sides
    assert port_side.dm.params.names == jax_side.dm.params.names
    assert list(port_side.dm.params.free.names) == ["delta_index", "theta23",
                                                    "aeff_scale"]
    assert port_side.dm.params.free.names == jax_side.dm.params.free.names
    want, got = jax_side.data, port_side.data
    assert len(got) == 1 and got.name == "toy"
    assert got[0].name == want[0].name
    np.testing.assert_allclose(got[0].hist, want[0].hist, rtol=VALUE_RTOL,
                               atol=0)
    # per pipeline, per map, off nominal
    for side in sides:
        side.start()
    outs = [side.dm.get_outputs() for side in sides]
    for m in outs[0][0]:
        np.testing.assert_allclose(outs[1][0][m.name].hist, m.hist,
                                   rtol=VALUE_RTOL, atol=0, err_msg=m.name)


def test_compiled_sum_hist_matches(sides):
    jax_side, port_side = sides
    for side in sides:
        side.start()
    want = JaxCompiled(jax_side.dm).sum_hist()
    cd = CompiledDistribution(port_side.dm)
    assert not cd.capture  # eager on the CPU
    np.testing.assert_allclose(cd.sum_hist(), np.asarray(want),
                               rtol=VALUE_RTOL, atol=0)
    maps = cd.get_outputs(return_sum=True)
    assert [m.name for m in maps] == ["toy"]
    np.testing.assert_allclose(maps[0].hist.ravel(), np.asarray(want),
                               rtol=VALUE_RTOL, atol=0)


@pytest.mark.parametrize("metric", ["mod_chi2", "chi2", "llh"])
def test_compiled_objective_matches(sides, metric):
    jax_side, port_side = sides
    for side in sides:
        side.start()
    jax_cd = JaxCompiled(jax_side.dm)
    cd = BasicAnalysis()._get_compiled(port_side.dm)
    x = cd.current_rescaled_values()
    np.testing.assert_allclose(x, jax_cd.current_rescaled_values(), rtol=0,
                               atol=1e-15)
    _, jax_vg = jax_cd.build_objective(jax_side.data, metric)
    value_fn, vg = cd.build_objective(port_side.data, metric)
    # memoized on the data's content
    assert cd.build_objective(port_side.data, metric)[1] is vg
    want_v, want_g = (np.asarray(a) for a in jax_vg(x))
    value, grad = vg(x)
    assert isinstance(value, torch.Tensor) and value.device.type == "cpu"
    np.testing.assert_allclose(float(value), float(want_v), rtol=VALUE_RTOL)
    np.testing.assert_allclose(float(value_fn(x)), float(want_v),
                               rtol=VALUE_RTOL)
    assert np.abs(grad.numpy() - want_g).max() <= (
        GRAD_ATOL_FRACTION * np.abs(want_g).max())


def test_device_fit_matches(sides):
    """method 'device': optax's L-BFGS in both packages, the same
    iterations."""
    jax_result, port_result = (side.fit("device") for side in sides)
    meta = port_result.minimizer_metadata
    assert meta["method"] == "device_lbfgs"
    assert meta["nit"] == jax_result.minimizer_metadata["nit"] > 0
    # one flag read per evaluation after the first
    assert meta["reads"] == meta["nfev"] - 1
    _same_fit(jax_result, port_result)
    assert abs(port_result.params["theta23"].value.m_as("degree")
               - TRUTH["theta23"]) < 0.5
    # the hypo maker is left at the best fit
    np.testing.assert_allclose(
        np.asarray(sides[1].dm.params.free._rescaled_values),
        _x(port_result), atol=1e-12)


def test_device_fit_takes_its_hypo_makers_device(sides):
    """The JAX package's platform routing has no counterpart: the fit runs
    where the hypo maker lives, and a device naming another raises."""
    _, port_side = sides
    analysis = BasicAnalysis()
    with pytest.raises(ValueError, match="no platform routing"):
        analysis.fit_recursively(port_side.data, port_side.dm, "mod_chi2",
                                 None, "device", {"platform": "cpu"}, None)
    with pytest.raises(ValueError, match="the hypo maker lives on cpu"):
        analysis.fit_recursively(port_side.data, port_side.dm, "mod_chi2",
                                 None, "device", {"device": "meta"}, None)


def test_gradient_fit_and_state_round_trip(sides):
    """method 'gradient': scipy L-BFGS-B on the analytic gradient, the same
    evaluations; the result's state survives a round trip."""
    jax_result, port_result = (side.fit("gradient") for side in sides)
    for key in ("nit", "nfev", "method", "success"):
        assert (port_result.minimizer_metadata[key]
                == jax_result.minimizer_metadata[key]), key
    _same_fit(jax_result, port_result)
    np.testing.assert_allclose(port_result.metric_val, jax_result.metric_val,
                               rtol=1e-6, atol=1e-15)
    assert isinstance(port_result, HypoFitResult)
    state = port_result.state
    want = jax_result.state
    assert list(state) == list(want)
    assert state["num_distributions_generated"] == (
        want["num_distributions_generated"])
    again = HypoFitResult.from_state(state)
    assert again.metric_val == port_result.metric_val
    assert again.params == state["params"]
    assert [m["name"] for m in again.hypo_asimov_dist] == [
        m.name for m in jax_result.hypo_asimov_dist]
    assert port_result.minimizer_time.m_as("s") > 0


def test_slsqp_from_settings_file_matches(sides):
    """The reference's settings-file schema (settings/minimizer/*.json),
    read in place, through Analysis.fit_hypo."""
    results = []
    for side in sides:
        side.start()
        result, _ = side.analysis().fit_hypo(
            side.data, side.dm, "mod_chi2",
            minimizer_settings=(
                "settings/minimizer/slsqp_ftol1e-6_eps1e-4_maxiter1000.json"),
            reset_free=False,
        )
        results.append(result)
    jax_result, port_result = results
    assert port_result.minimizer_metadata["method"] == "slsqp"
    np.testing.assert_allclose(port_result.metric_val, jax_result.metric_val,
                               rtol=1e-6)
    _same_fit(jax_result, port_result, x_atol=1e-4)


def test_octants_pick_the_same_octant(sides):
    """The octant strategy around the device fit: both octants fitted, the
    first (truth's) wins in both packages, the range is restored."""
    def kwargs(u):
        return {"angle": "theta23", "inflection_point": 45 * u.degree}

    inner = {"method": "device", "method_kwargs": {}}
    jax_result, port_result = (side.fit("octants", kwargs, inner)
                               for side in sides)
    got = port_result.params["theta23"].value.m_as("degree")
    want = jax_result.params["theta23"].value.m_as("degree")
    assert got < 45.0 and want < 45.0
    assert abs(got - TRUTH["theta23"]) < 0.5
    _same_fit(jax_result, port_result)
    lo, hi = port_result.params["theta23"].range
    assert lo.m_as("degree") == 0.0 and hi.m_as("degree") == 90.0
    assert port_result.minimizer_metadata["nit"] == (
        jax_result.minimizer_metadata["nit"])


def test_best_of_keeps_the_same_fit(sides):
    """best_of over two short gradient fits (3 and 6 iterations): the same
    one wins in both packages, at the same point."""
    local = [{"method": "gradient",
              "method_kwargs": {"options": {"maxiter": n}}} for n in (3, 6)]
    jax_result, port_result = (side.fit("best_of", {}, local)
                               for side in sides)
    assert port_result.minimizer_metadata["nit"] == (
        jax_result.minimizer_metadata["nit"])
    _same_fit(jax_result, port_result)
    np.testing.assert_allclose(port_result.metric_val, jax_result.metric_val,
                               rtol=1e-6, atol=1e-12)


def test_grid_scan_metrics_match(sides):
    def kwargs(u):
        return {"grid": {"theta23": [40.0 * u.degree, 42.0 * u.degree,
                                     44.0 * u.degree]}}

    jax_result, port_result = (side.fit("grid_scan", kwargs, None,
                                        metric="chi2") for side in sides)
    got = [r.metric_val for r in port_result.grid_scan_results]
    want = [r.metric_val for r in jax_result.grid_scan_results]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    assert np.isclose(port_result.params["theta23"].value.m_as("degree"),
                      42.0)
    # the grid param is free again
    assert "theta23" in sides[1].dm.params.free.names


def test_profile_matches(sides):
    """Analysis.profile: theta23 fixed at each value, the rest fitted
    (the oscillation then has no free parameter, so no tangents run)."""
    results = []
    for side in sides:
        side.start()
        values = [v * side.ureg.degree for v in (40.0, 42.0, 44.0)]
        results.append(side.analysis().profile(
            side.data, side.dm, "theta23", values, "mod_chi2",
            method="gradient"))
    jax_results, port_results = results
    got = [r.metric_val for r in port_results]
    want = [r.metric_val for r in jax_results]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert got[1] < got[0] and got[1] < got[2]
    for j, p in zip(jax_results, port_results):
        assert list(p.params.free.names) == ["delta_index", "aeff_scale"]
        _same_fit(j, p)
    assert "theta23" in sides[1].dm.params.free.names


def test_native_hesse_errors_match(sides):
    """method 'iminuit' without the iminuit package: L-BFGS-B on the
    analytic gradient, then errors from central differences of it. Started
    at the truth, so the minimization is short."""
    results = []
    for side in sides:
        side.start(theta23=TRUTH["theta23"])
        results.append(side.analysis().fit_recursively(
            side.data, side.dm, "mod_chi2", None, "iminuit", {}, None))
    jax_result, port_result = results
    meta = port_result.minimizer_metadata
    assert meta["method"] == "iminuit-equivalent (native)"
    errs, want = meta["hesse_errors"], jax_result.minimizer_metadata[
        "hesse_errors"]
    assert set(errs) == set(want) == set(port_result.params.free.names)
    for name in want:
        assert np.isfinite(errs[name]) and errs[name] > 0, name
        np.testing.assert_allclose(errs[name], want[name], rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(
        meta["hesse_cov_rescaled"],
        jax_result.minimizer_metadata["hesse_cov_rescaled"], rtol=1e-4)


@pytest.mark.parametrize("method", ["nlopt", "iminuit_real"])
def test_routes_for_later_raise(sides, method):
    """The real-iminuit route waits for ROADMAP item 14. The nlopt method
    is ported (tests/test_torch_nlopt.py); what it still refuses, as the
    JAX package does, is an algorithm NLopt does not have."""
    _, port_side = sides
    analysis = BasicAnalysis()
    if method == "nlopt":
        with pytest.raises(ValueError, match="LN_BOGUS"):
            analysis.fit_recursively(
                port_side.data, port_side.dm, "mod_chi2", None, "nlopt",
                {"algorithm": "LN_BOGUS"}, None)
    else:
        with pytest.raises(NotImplementedError, match="item 14"):
            analysis._fit_iminuit_real(port_side.data, port_side.dm,
                                       "mod_chi2", None, {}, None)


@pytest.mark.parametrize("strategy", ["ranges", "staged", "condition"])
def test_other_strategies_run(sides, strategy):
    """The remaining recursive strategies, each around a no-fit inner step
    (a grid scan of one point), against the JAX package's."""
    def kwargs(u):
        grid = {"grid": {"theta23": [41.0 * u.degree]}}
        inner = {"method": "grid_scan", "method_kwargs": grid}
        if strategy == "ranges":
            return ({"param_name": "delta_index",
                     "ranges": [(-0.2, 0.0), (0.0, 0.2)]}, inner)
        if strategy == "staged":
            return {}, [inner, inner]
        return ({"condition_func": lambda hm: True}, [inner, inner])

    results = []
    for side in sides:
        method_kwargs, local = kwargs(side.ureg)
        results.append(side.fit(strategy, method_kwargs, local))
    jax_result, port_result = results
    np.testing.assert_allclose(port_result.metric_val, jax_result.metric_val,
                               rtol=1e-9)
    _same_fit(jax_result, port_result)


def test_pipeline_fitting_surface():
    """The Pipeline methods the layers above call (reference
    pipeline.py:172-448): setters, resets, update_params, output binning
    and key, profiling, the stage table."""
    from pisa_tpu_torch.core.param import ParamSet
    from pisa_tpu_torch.core.pipeline import Pipeline

    pipeline = Pipeline(CFG, device="cpu", profile=True)
    assert pipeline.detector_name is None
    free = pipeline.params.free
    pipeline._set_rescaled_free_params([0.25] * len(free))
    assert all(p._rescaled_value == pytest.approx(0.25) for p in free)
    pipeline.set_free_params([p.nominal_value for p in free])
    assert all(p.value == p.nominal_value for p in free)
    pipeline.params["aeff_scale"].value = 2.0
    pipeline.params["nu_nc_norm"].value = 0.9
    pipeline.reset_free()
    assert pipeline.params["aeff_scale"].value.magnitude == 1.0
    assert pipeline.params["nu_nc_norm"].value.magnitude == 0.9
    pipeline.reset_all()
    assert pipeline.params["nu_nc_norm"].value.magnitude == 0.8

    other = Pipeline(CFG, device="cpu")
    pipeline.update_params(ParamSet([other.params["aeff_scale"]]))
    assert pipeline.params["aeff_scale"] is other.params["aeff_scale"]
    assert pipeline["aeff.aeff"].params["aeff_scale"] is (
        other.params["aeff_scale"])

    binning = pipeline.output_binning
    pipeline.output_binning = None
    with pytest.raises(ValueError, match="No output binning"):
        pipeline.get_outputs()
    pipeline.output_binning = binning
    pipeline.output_key = "weights"
    summed = pipeline.get_outputs(return_sum=True)
    assert len(summed) == 1
    np.testing.assert_allclose(
        summed[0].hist, sum(m.hist for m in pipeline.get_outputs()),
        rtol=1e-12)

    assert len(pipeline._get_outputs_times) == 2
    assert pipeline["osc.prob3"].calc_times
    assert pipeline["aeff.aeff"].apply_times
    table = pipeline.tabulate()
    assert table.splitlines()[0].split()[:3] == ["stage", "number", "name"]
    assert len(table.splitlines()) == 1 + len(pipeline.stages)
    assert pipeline.tabulate("html").startswith("<table>")
    assert len(pipeline.tabulate("presto").splitlines()) == 2 + len(
        pipeline.stages)
    assert str(pipeline).startswith("Pipeline('neutrinos': data.")


def test_profile_report_and_distribution_maker_surface(capsys):
    dm = DistributionMaker([CFG, CFG], label="two", device="cpu",
                           profile=True)
    # same-named params are one object across the pipelines
    assert dm[0].params["theta23"] is dm[1].params["theta23"]
    assert len(dm) == 2 and list(dm) == dm.pipelines
    dm.get_outputs(return_sum=True)
    dm.report_profile(detailed=True)
    out = capsys.readouterr().out
    assert out.count("Pipeline: neutrinos") == 2
    assert "get_outputs:" in out and "compute:" in out
    dm.randomize_free_params(random_state=3)
    assert dm.params["theta23"].value.m_as("degree") != 42.0
    dm.reset_all()
    assert dm.params["theta23"].value.m_as("degree") == pytest.approx(42.0)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DistributionMaker([CFG])


@pytest.mark.cuda
def test_compiled_distribution_captures_one_program():
    """On the card, the summed objective over all pipelines is one captured
    program (not one graph per pipeline), and the device fit reads one flag
    per evaluation after the first."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    from pisa_tpu_torch.core import template as template_module

    dm = DistributionMaker([CFG, CFG], label="two", device="cuda")
    dm.params["theta23"].value = 42 * ureg.degree
    data = dm.get_outputs(return_sum=True)
    dm.params["theta23"].value = 39 * ureg.degree
    captured = []
    original = template_module._CapturedProgram._capture

    def spy(self, fn):
        captured.append(type(self).__name__)
        return original(self, fn)

    template_module._CapturedProgram._capture = spy
    try:
        cd = CompiledDistribution(dm)
        value_fn, vg = cd.build_objective(data, "mod_chi2")
    finally:
        template_module._CapturedProgram._capture = original
    # value_and_grad and value: two graphs of one program
    assert captured == ["CapturedObjective", "CapturedObjective"]
    assert value_fn.program is vg.program
    eager = CompiledDistribution(dm, capture=False)
    _, eager_vg = eager.build_objective(data, "mod_chi2")
    x = cd.current_rescaled_values()
    v, g = (t.cpu().numpy() for t in vg(x))
    ve, ge = (t.cpu().numpy() for t in eager_vg(x))
    np.testing.assert_allclose(v, ve, rtol=1e-12)
    assert np.abs(g - ge).max() <= 1e-12 * np.abs(ge).max()
    result = Analysis().fit_recursively(data, dm, "mod_chi2", None,
                                        "device", {}, None)
    meta = result.minimizer_metadata
    assert meta["reads"] == meta["nfev"] - 1
    assert abs(result.params["theta23"].value.m_as("degree") - 42.0) < 0.5
