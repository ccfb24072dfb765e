"""
The port's compiled template (``Pipeline(...).compile()``,
``pisa_tpu_torch/core/template.py``) against the JAX package's: the flagship
``settings/pipeline/IceCube_3y_neutrinos.cfg`` with the ``true_allsky_fine``
oscillation grid cut from 200x200 to 20x20 (as tests/test_torch_pipeline.py
cuts it) and all 240k events, in fp64 on the CPU (conftest). On the CPU the
JAX package takes its gradient by reverse mode through its XLA formulation;
the port's goes through its autograd Function, whose backward runs the plain
tangents. The JAX template's rescaled vector, bounds and gradient reach the
port's order through ``pisa_tpu_torch.utils.interop``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.config.parser import parse_pipeline_config as jax_parse
from pisa_tpu.core import binning as jax_binning
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu_torch import ureg as torch_ureg
from pisa_tpu_torch.config.parser import parse_pipeline_config as torch_parse
from pisa_tpu_torch.core import binning as torch_binning
from pisa_tpu_torch.core.pipeline import Pipeline as TorchPipeline
from pisa_tpu_torch.ops.osc import chain
from pisa_tpu_torch.utils.interop import (
    template_inputs_from_jax,
    to_template_order,
)
from test_torch_pipeline import _small_grid_config

# value and gradient tolerances (fp64 on both sides; the two packages differ
# only in operation order)
VALUE_RTOL = 1e-9
GRAD_RTOL = 1e-7
GRAD_ATOL_FRACTION = 1e-9  # of max |gradient|


@pytest.fixture(scope="module")
def templates():
    """(JAX template, port pipeline, port template, JAX nominal Asimov data,
    port eager outputs taken before compiling)."""
    jax_ct = JaxPipeline(
        _small_grid_config(jax_parse, jax_binning, jax_ureg)).compile()
    pipeline = TorchPipeline(
        _small_grid_config(torch_parse, torch_binning, torch_ureg),
        device="cpu",
    )
    eager = pipeline.get_outputs()
    ct = pipeline.compile()
    data = jax_ct.get_outputs(jax_ct.current_rescaled_values())
    return jax_ct, pipeline, ct, data, eager


@pytest.fixture(scope="module")
def jax_objectives(templates):
    jax_ct, _, _, data, _ = templates
    return {priors: jax_ct.build_objective(_as_arrays(data), "mod_chi2", priors=priors)
            for priors in (True, False)}


def _as_arrays(maps):
    """A JAX-package MapSet as {name: numpy hist}, the port's data input."""
    return {m.name: np.asarray(m.hist) for m in maps}


def _points(jax_ct):
    """The test_rate_defer.py:79-94 point (nominal, clipped to
    [0.15, 0.85]), where Asimov data at nominal puts the objective at its
    minimum, and a seeded perturbation of it (test_rate_defer.py:97-116),
    away from the minimum, where the gradient is not round-off."""
    v0 = np.clip(np.asarray(jax_ct.current_rescaled_values()), 0.15, 0.85)
    rng = np.random.RandomState(5)
    return {
        "nominal": v0,
        "perturbed": np.clip(v0 + rng.uniform(-0.1, 0.1, v0.size), 0.15, 0.85),
    }


def test_free_params_and_bounds_match_jax(templates):
    jax_ct, _, ct, _, _ = templates
    assert len(ct.free_names) == 15
    assert sorted(ct.free_names) == sorted(jax_ct.free_names)
    los, his = jax_ct._current_bounds()
    _, plos, phis = template_inputs_from_jax(
        ct, jax_ct.free_names, jax_ct.current_rescaled_values(), los, his)
    np.testing.assert_array_equal(plos, ct._current_bounds()[0])
    np.testing.assert_array_equal(phis, ct._current_bounds()[1])
    np.testing.assert_allclose(
        ct.current_rescaled_values(),
        to_template_order(ct, jax_ct.free_names,
                          jax_ct.current_rescaled_values()),
        rtol=0, atol=1e-12,
    )
    assert [s.service_name for s in ct._hoisted_stages] == [
        "csv_loader", "honda_ip"]


def test_template_matches_eager_and_leaves_it_unchanged(templates):
    """The template at the current values equals the eager
    get_outputs(); afterwards the eager path gives what it gave before."""
    _, pipeline, ct, _, eager = templates
    got = ct.get_outputs()
    assert [m.name for m in got] == [m.name for m in eager]
    for m in eager:
        np.testing.assert_allclose(got[m.name].hist, m.hist, rtol=1e-12,
                                   atol=0, err_msg=m.name)
        np.testing.assert_allclose(got[m.name].error_hist, m.error_hist,
                                   rtol=1e-12, atol=0, err_msg=m.name)
    again = pipeline.get_outputs()
    for m in eager:
        np.testing.assert_array_equal(again[m.name].hist, m.hist)
        np.testing.assert_array_equal(again[m.name].error_hist, m.error_hist)


def test_template_matches_jax_template_off_nominal(templates):
    jax_ct, _, ct, _, _ = templates
    v = _points(jax_ct)["perturbed"]
    want = jax_ct.get_outputs(v)
    got = ct.get_outputs(to_template_order(ct, jax_ct.free_names, v))
    for m in want:
        np.testing.assert_allclose(got[m.name].hist, np.asarray(m.hist),
                                   rtol=1e-10, atol=0, err_msg=m.name)


@pytest.mark.parametrize("priors", [True, False], ids=["priors", "no-priors"])
@pytest.mark.parametrize("multitangent", [False, True],
                         ids=["tangents", "multitangent"])
def test_value_and_grad_matches_jax(templates, jax_objectives, priors,
                                    multitangent):
    """mod_chi2 value and all 15 gradient entries against the JAX
    template's build_objective, off the minimum (value 1e-9 relative;
    gradient rtol 1e-7 with atol 1e-9 max|g|); at the minimum the values
    agree to 1e-9 and both gradients are round-off."""
    jax_ct, pipeline, ct, data, _ = templates
    _, jax_vg = jax_objectives[priors]
    value_fn, vg = ct.build_objective(_as_arrays(data), "mod_chi2", priors=priors)
    default = pipeline["osc.prob3"].multitangent
    pipeline["osc.prob3"].multitangent = multitangent
    los, his = jax_ct._current_bounds()
    try:
        for label, v in _points(jax_ct).items():
            want_v, want_g = jax_vg(jnp.asarray(v))
            want_g = to_template_order(ct, jax_ct.free_names, want_g)
            vec, _, _ = template_inputs_from_jax(ct, jax_ct.free_names, v,
                                                 los, his)
            got_v, got_g = vg(vec)
            np.testing.assert_allclose(float(got_v), float(want_v),
                                       rtol=VALUE_RTOL, atol=0)
            np.testing.assert_allclose(float(value_fn(vec)), float(want_v),
                                       rtol=VALUE_RTOL, atol=0)
            got_g = got_g.numpy()
            if label == "perturbed":
                scale = np.abs(want_g).max()
                assert np.all(want_g != 0.0)
                for name, a, b in zip(ct.free_names, got_g, want_g):
                    np.testing.assert_allclose(
                        a, b, rtol=GRAD_RTOL,
                        atol=GRAD_ATOL_FRACTION * scale, err_msg=name)
                perturbed_scale = scale
            else:
                nominal = (got_g, want_g)
        # at the minimum both gradients are round-off next to the
        # off-minimum gradient
        for g in nominal:
            assert np.abs(g).max() < 1e-8 * perturbed_scale
    finally:
        pipeline["osc.prob3"].multitangent = default


def test_gradient_launches_on_the_path(templates):
    """The backward asks for one multitangent pass per sign (prob3's
    default), or, with ``multitangent = False``, for one tangent per free
    oscillation parameter and sign (on the CPU the wrappers take the plain
    versions, so this counts their calls)."""
    jax_ct, pipeline, ct, data, _ = templates
    _, vg = ct.build_objective(_as_arrays(data), "mod_chi2")
    v = to_template_order(ct, jax_ct.free_names,
                          _points(jax_ct)["perturbed"])
    calls = {"tangent": 0, "multitangent": 0}
    tangent, multitangent = chain.chain_tangent, chain.chain_multitangent

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    chain.chain_tangent = count("tangent", tangent)
    chain.chain_multitangent = count("multitangent", multitangent)
    assert pipeline["osc.prob3"].multitangent is True
    try:
        vg(v)
        assert calls == {"tangent": 0, "multitangent": 2}
        pipeline["osc.prob3"].multitangent = False
        vg(v)
        assert calls == {"tangent": 6, "multitangent": 2}
    finally:
        chain.chain_tangent, chain.chain_multitangent = tangent, multitangent
        pipeline["osc.prob3"].multitangent = True


@pytest.mark.parametrize("metric", ["chi2", "llh", "poisson_llh"])
def test_other_metrics_value_matches_jax(templates, metric):
    jax_ct, _, ct, data, _ = templates
    v = _points(jax_ct)["perturbed"]
    jax_value, _ = jax_ct.build_objective(_as_arrays(data), metric)
    value_fn, _ = ct.build_objective(_as_arrays(data), metric)
    got = float(value_fn(to_template_order(ct, jax_ct.free_names, v)))
    np.testing.assert_allclose(got, float(jax_value(jnp.asarray(v))),
                               rtol=VALUE_RTOL, atol=0)


def test_unported_metric_raises(templates):
    """Every metric is ported now: an unknown one still raises, and the
    generalized likelihood on a pipeline that makes no mixture inputs says
    what is missing."""
    _, _, ct, data, _ = templates
    with pytest.raises(ValueError, match="no_such_metric"):
        ct.build_objective(_as_arrays(data), "no_such_metric")
    value_fn, _ = ct.build_objective(_as_arrays(data),
                                     "generalized_poisson_llh")
    with pytest.raises(ValueError, match="llh_alphas"):
        value_fn(ct.current_rescaled_values())


@pytest.mark.parametrize("metric", ["mod_chi2", "mcllh_eff", "conv_llh"])
def test_sum_maps_matches_jax(templates, metric):
    """``build_objective(sum_maps=True)``: the metric of the summed data
    against the summed template (``pisa_tpu/core/template.py:701``), value
    and gradient, on the stacked flagship."""
    jax_ct, _, ct, data, _ = templates
    v = _points(jax_ct)["perturbed"]
    _, jax_vg = jax_ct.build_objective(_as_arrays(data), metric,
                                       sum_maps=True)
    _, vg = ct.build_objective(_as_arrays(data), metric, sum_maps=True)
    value, grad = vg(to_template_order(ct, jax_ct.free_names, v))
    want_value, want_grad = jax_vg(jnp.asarray(v))
    np.testing.assert_allclose(float(value), float(want_value),
                               rtol=VALUE_RTOL, atol=0)
    want_grad = to_template_order(ct, jax_ct.free_names,
                                  np.asarray(want_grad))
    np.testing.assert_allclose(
        grad.numpy(), want_grad, rtol=0,
        atol=GRAD_ATOL_FRACTION * np.abs(want_grad).max())


def test_free_host_param_raises(templates):
    _, pipeline, _, _, _ = templates
    ye = pipeline.params["YeI"]
    ye.is_fixed = False
    try:
        with pytest.raises(ValueError, match="YeI"):
            pipeline.compile()
    finally:
        ye.is_fixed = True


def test_template_values_reach_params_only_inside(templates):
    """Outside an evaluation the params hold their eager values, and the
    values hash as before (no tensor left behind)."""
    jax_ct, pipeline, ct, data, _ = templates
    before = pipeline.params.values_hash
    _, vg = ct.build_objective(_as_arrays(data), "mod_chi2")
    vg(to_template_order(ct, jax_ct.free_names, _points(jax_ct)["perturbed"]))
    assert pipeline.params.values_hash == before is not None
    for p in pipeline.params:
        assert not isinstance(getattr(p.value, "magnitude", None),
                              torch.Tensor)


def test_param_holds_template_tensor_values():
    """A Param whose magnitude is a 0-d tensor (as the template sets it):
    m_as keeps the graph, the log-rescaled value is a differentiable
    tensor, the values hash is None (never cached), and the range check
    leaves it to the template."""
    from pisa_tpu_torch.core.param import Param, ParamSet
    from pisa_tpu_torch.units import Quantity

    ev2 = torch_ureg.eV**2
    p = Param("dm", 2.5e-3 * ev2, range=(1e-3 * ev2, 7e-3 * ev2),
              is_fixed=False, scales_as_log=True)
    mag = torch.tensor(3e-3, dtype=torch.float64, requires_grad=True)
    p._value = Quantity(mag, p.units)
    (slope,) = torch.autograd.grad(p.m_as("eV**2"), mag)
    assert float(slope) == 1.0
    r = p._rescaled_value
    assert isinstance(r, torch.Tensor) and r.requires_grad
    want = np.log(3e-3 / 1e-3) / np.log(7e-3 / 1e-3)
    np.testing.assert_allclose(float(r.detach()), want, rtol=1e-14)
    (dr,) = torch.autograd.grad(r, mag)
    np.testing.assert_allclose(float(dr), 1 / (3e-3 * np.log(7.0)),
                               rtol=1e-12)
    assert ParamSet([p]).values_hash is None
    p.validate_value(Quantity(torch.tensor(1.0, dtype=torch.float64),
                              p.units))
    p.value = 2.5e-3 * torch_ureg.eV**2
    assert ParamSet([p]).values_hash is not None
    with pytest.raises(ValueError, match="out of range"):
        p.value = 9e-3 * torch_ureg.eV**2


def test_routes_share_the_objective_code(templates):
    """capture is for a CUDA device: on the CPU the same objective runs
    eagerly, asking for a capture raises, and the objective says where it
    lives (analysis/device_fit.py checks it)."""
    _, pipeline, ct, data, _ = templates
    with pytest.raises(ValueError, match="CUDA device"):
        ct.build_objective(_as_arrays(data), "mod_chi2", capture=True)
    value_fn, _ = ct.build_objective(_as_arrays(data), "mod_chi2",
                                     capture=False)
    assert value_fn.raw.device == pipeline.device == torch.device("cpu")


# -- on the card: the captured program ------------------------------------------
class _OnCardOnly(torch.utils._python_dispatch.TorchDispatchMode):
    """Raises when an operation gives a tensor that does not lie on the
    card."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.device.type != "cuda":
                raise AssertionError(f"{func} gave a tensor on {t.device}")
        return out


@pytest.fixture(scope="module")
def card_pipeline():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return TorchPipeline(
        _small_grid_config(torch_parse, torch_binning, torch_ureg),
        device="cuda",
    )


def _card_point(ct, seed):
    v0 = np.clip(ct.current_rescaled_values(), 0.15, 0.85)
    rng = np.random.RandomState(seed)
    return np.clip(v0 + rng.uniform(-0.1, 0.1, v0.size), 0.15, 0.85)


@pytest.mark.cuda
@pytest.mark.parametrize("rate_defer", [True, False],
                         ids=["deferral", "gather"])
def test_captured_replay_matches_eager_on_the_card(card_pipeline, rate_defer):
    """fp64 on the card: a replay of the captured value_and_grad equals a
    fresh eager run to 1e-12 relative (the same kernels in the same order;
    atomics may reorder sums), at a first point, at another one, and after a
    change of a parameter's range (the bounds are inputs of the graph); the
    eager get_outputs() of the same pipeline is untouched."""
    pipeline = card_pipeline
    eager_maps = pipeline.get_outputs()
    ct = pipeline.compile(rate_defer=rate_defer)
    assert ct.stacked and ct.rate_deferred is rate_defer
    data = ct.get_outputs()
    eager_value, eager_vg = ct.build_objective(data, "mod_chi2", capture=False)
    value_fn, vg = ct.build_objective(data, "mod_chi2")

    def check(v):
        want_v, want_g = eager_vg(v)
        got_v, got_g = vg(v)
        assert got_v.device.type == got_g.device.type == "cuda"
        np.testing.assert_allclose(float(got_v), float(want_v), rtol=1e-12)
        np.testing.assert_allclose(float(value_fn(v)), float(eager_value(v)),
                                   rtol=1e-12)
        scale = float(want_g.abs().max())
        np.testing.assert_allclose(got_g.cpu().numpy(), want_g.cpu().numpy(),
                                   rtol=1e-9, atol=1e-12 * scale)
        return float(got_v)

    first = check(_card_point(ct, 5))
    assert check(_card_point(ct, 6)) != first
    theta23 = pipeline.params["theta23"]
    saved = theta23.range
    lo, hi = saved
    theta23.range = (lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo))
    try:
        narrowed = check(_card_point(ct, 5))
    finally:
        theta23.range = saved
    assert narrowed != first
    assert check(_card_point(ct, 5)) == pytest.approx(first, rel=1e-12)
    again = pipeline.get_outputs()
    for m in eager_maps:
        np.testing.assert_array_equal(again[m.name].hist, m.hist)


@pytest.mark.cuda
def test_capture_counts_launches_and_replay_does_not_wait(card_pipeline):
    """The launch counters advance where the wrappers launch, that is at
    the warm-up runs and the capture (2 primal + 2 multitangent per
    value_and_grad, 2 primal per value), and not at a replay; a replay
    with its vector on the card waits for nothing until the value is
    read."""
    from pisa_tpu_torch.core.template import CAPTURE_WARMUP

    ct = card_pipeline.compile()
    data = ct.get_outputs()
    before = (chain.launch_count, chain.tangent_launch_count,
              chain.multitangent_launch_count)
    _, vg = ct.build_objective(data, "mod_chi2")
    after = (chain.launch_count, chain.tangent_launch_count,
             chain.multitangent_launch_count)
    runs = CAPTURE_WARMUP + 1
    assert tuple(a - b for a, b in zip(after, before)) == (
        runs * 2 + runs * 2, 0, runs * 2)
    vec = torch.as_tensor(_card_point(ct, 5), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        value, grad = vg(vec)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(value)) and grad.shape == (15,)
    assert (chain.launch_count, chain.tangent_launch_count,
            chain.multitangent_launch_count) == after


@pytest.mark.cuda
def test_capture_is_safe_from_the_garbage_collector(card_pipeline):
    """Captured programs left in a reference cycle are freed by the garbage
    collector, whenever it runs. If it ran inside another capture, CUDA
    would refuse to destroy their graphs there and that capture would fail:
    a capture collects first, so a collection inside it finds nothing."""
    import gc

    from pisa_tpu_torch.core.template import CAPTURE_WARMUP, CapturedFunction

    ct = card_pipeline.compile()
    value_fn, vg = ct.build_objective(ct.get_outputs(), "mod_chi2")
    cycle = [value_fn, vg]
    cycle.append(cycle)
    del value_fn, vg, cycle
    calls = []

    def fn(vec, los, his):
        calls.append(None)
        if len(calls) == CAPTURE_WARMUP + 1:  # the run being captured
            gc.collect()
        return (vec * 2.0,)

    vec = torch.as_tensor(_card_point(ct, 5), device="cuda")
    program = CapturedFunction(fn, vec, *ct._device_bounds(), device=vec.device)
    (out,) = program(vec + 1.0, *ct._device_bounds())
    torch.testing.assert_close(out, 2.0 * (vec + 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["stacked+deferral", "stacked", "unstacked"])
def test_no_cpu_tensor_in_the_evaluated_path(card_pipeline, route):
    """With the vector on the card, the eager evaluation makes no tensor
    on the CPU (forward, seen operation by operation) and waits for the
    card nowhere (forward and backward, torch's sync debug mode)."""
    kw = {"stacked+deferral": dict(rate_defer=True),
          "stacked": dict(rate_defer=False),
          "unstacked": dict(stack=False)}[route]
    ct = card_pipeline.compile(**kw)
    data = ct.get_outputs()
    value_fn, vg = ct.build_objective(data, "mod_chi2", capture=False)
    vec = torch.as_tensor(_card_point(ct, 5), device="cuda")
    vg(vec)  # builds what is cached at first use
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with _OnCardOnly():
            value = value_fn(vec)
        value2, grad = vg(vec)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert value.device.type == grad.device.type == "cuda"
    assert float(value) == pytest.approx(float(value2), rel=1e-12)


@pytest.mark.cuda
def test_captured_template_call_matches_eager(card_pipeline):
    """On the card the template call is captured at its first call: a
    replay equals a fresh eager run of the same template to 1e-12 per bin
    (fp64), at two points and after a range change, and waits once (the
    read of its result)."""
    ct = card_pipeline.compile()
    eager = card_pipeline.compile(capture=False)
    assert ct.capture and not eager.capture

    def worst(point):
        got, want = ct.get_outputs(point), eager.get_outputs(point)
        assert [m.name for m in got] == [m.name for m in want]
        return max(
            float(np.abs(g.hist - w.hist).max() / np.abs(w.hist).max())
            for g, w in zip(got, want))

    assert worst(_card_point(ct, 5)) <= 1e-12
    assert worst(_card_point(ct, 6)) <= 1e-12
    theta23 = card_pipeline.params["theta23"]
    saved = theta23.range
    lo, hi = saved
    theta23.range = (lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo))
    try:
        assert worst(_card_point(ct, 5)) <= 1e-12
    finally:
        theta23.range = saved
    out = ct(_card_point(ct, 5))
    assert list(out["hist"]) == ct.names
    assert all(h.device.type == "cuda" for h in out["hist"].values())


@pytest.mark.cuda
def test_scan_totals_are_the_calls_totals(card_pipeline):
    """scan_totals on the card: n replays with their totals copied into
    one tensor, the same as n calls' totals; nothing waits until the read."""
    ct = card_pipeline.compile()
    vecs = np.random.RandomState(0).uniform(0.05, 0.95,
                                            (6, len(ct.free_names)))
    want = [float(sum(h.sum() for h in ct(v)["hist"].values()))
            for v in vecs]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        totals = ct.scan_totals(vecs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert totals.shape == (6,) and totals.device.type == "cuda"
    np.testing.assert_allclose(totals.cpu().numpy(), want, rtol=1e-12)
