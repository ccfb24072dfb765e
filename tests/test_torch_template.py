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
    _, _, ct, data, _ = templates
    with pytest.raises(NotImplementedError, match="barlow_llh"):
        ct.build_objective(_as_arrays(data), "barlow_llh")
    with pytest.raises(ValueError, match="no_such_metric"):
        ct.build_objective(_as_arrays(data), "no_such_metric")


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
