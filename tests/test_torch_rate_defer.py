"""
The port's rate deferral (``CompiledTemplate._setup_rate_deferral``,
``prob3._apply_stacked``, ``hist.prepare_rate_defer``): the oscillation
stage hands its (6, ngrid) flux x probability rate to the histogram stage,
which contracts it with static (category x grid x bins) matrices S and S2.

On the 20x20-grid flagship (tests/test_torch_pipeline.py) with all 240k
events, fp64 on the CPU (conftest): deferral is really on where the template
says so (tests/test_rate_defer.py:41); S and S2 equal the JAX package's,
read off its stacked container as numpy (both packages accumulate them on
the host in float64 in event order, so to MATRIX_RTOL = 1e-14); the deferred
template, errors and gradient equal the gather route's to the operation
order (ROUTE_RTOL = 1e-11; tests/test_torch_stacking.py holds both against
the JAX package). And the two faults of the JAX package that the port does
not copy: matrices left behind by a set-up that gives up, and a hand-off
kept on stage objects that two templates over one pipeline share.
"""

import numpy as np
import pytest

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.config.parser import parse_pipeline_config as jax_parse
from pisa_tpu.core import binning as jax_binning
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu_torch import ureg as torch_ureg
from pisa_tpu_torch.config.parser import parse_pipeline_config as torch_parse
from pisa_tpu_torch.core import binning as torch_binning
from pisa_tpu_torch.core.container import Container, ContainerSet
from pisa_tpu_torch.core.pipeline import Pipeline as TorchPipeline
from pisa_tpu_torch.stages.utils.hist import hist
from test_torch_pipeline import _small_grid_config

MATRIX_RTOL = 1e-14
ROUTE_RTOL = 1e-11


@pytest.fixture(scope="module")
def pipeline():
    return TorchPipeline(
        _small_grid_config(torch_parse, torch_binning, torch_ureg),
        device="cpu",
    )


@pytest.fixture(scope="module")
def pair(pipeline):
    """(deferred template, gather template) over one pipeline."""
    return pipeline.compile(rate_defer=True), pipeline.compile(rate_defer=False)


def _perturbed(ct):
    rng = np.random.RandomState(5)
    v0 = np.clip(ct.current_rescaled_values(), 0.15, 0.85)
    return np.clip(v0 + rng.uniform(-0.1, 0.1, v0.size), 0.15, 0.85)


def _deferred_calls(fn):
    """How often the histogram stage took the factorized route in fn()."""
    calls = []
    original = hist._apply_stacked_deferred

    def counted(self, container, dr):
        calls.append(container)
        return original(self, container, dr)

    hist._apply_stacked_deferred = counted
    try:
        fn()
    finally:
        hist._apply_stacked_deferred = original
    return len(calls)


def test_deferral_is_active(pair):
    ct_defer, ct_gather = pair
    assert ct_defer.stacked and ct_defer.rate_deferred
    assert ct_gather.stacked and not ct_gather.rate_deferred
    sc = ct_defer._trace_data.containers[0]
    assert sc.rate_defer["S"].shape == (12, 400, 128)
    assert sc.rate_defer["S2"].shape == (12, 400, 128)
    assert ct_gather._trace_data.containers[0].rate_defer is None
    v = _perturbed(ct_defer)
    assert _deferred_calls(lambda: ct_defer.get_outputs(v)) == 1
    assert _deferred_calls(lambda: ct_gather.get_outputs(v)) == 0
    # the hand-off does not outlive the evaluation
    assert sc.deferred_rate is None


def test_matrices_match_jax(pair):
    """S and S2 against the JAX package's, category by category (both
    pipelines load the categories in the config's order)."""
    ct_defer, _ = pair
    jax_ct = JaxPipeline(
        _small_grid_config(jax_parse, jax_binning, jax_ureg)).compile()
    jax_sc = jax_ct._trace_data.containers[0]
    sc = ct_defer._trace_data.containers[0]
    assert list(jax_sc.cat_names) == sc.cat_names
    h = hash("events")
    for key in ("S", "S2"):
        want = np.asarray(jax_sc._data[f"_rate_defer_{key}"][h])
        got = sc.rate_defer[key].numpy()
        assert got.dtype == want.dtype == np.float64
        assert np.count_nonzero(want) > 10_000
        np.testing.assert_allclose(got, want, rtol=MATRIX_RTOL, atol=0,
                                   err_msg=key)


@pytest.mark.parametrize("point", ["nominal", "perturbed"])
def test_deferred_template_matches_gather(pair, point):
    ct_defer, ct_gather = pair
    v = (_perturbed(ct_defer) if point == "perturbed"
         else ct_defer.current_rescaled_values())
    want = ct_gather.get_outputs(v)
    for m in ct_defer.get_outputs(v):
        np.testing.assert_allclose(m.hist, want[m.name].hist,
                                   rtol=ROUTE_RTOL, atol=0, err_msg=m.name)
        np.testing.assert_allclose(m.error_hist, want[m.name].error_hist,
                                   rtol=ROUTE_RTOL, atol=0, err_msg=m.name)


def test_deferred_gradient_matches_gather(pair):
    ct_defer, ct_gather = pair
    data = ct_gather.get_outputs()
    v = _perturbed(ct_defer)
    (val_d, grad_d), (val_g, grad_g) = (
        ct.build_objective(data, "mod_chi2")[1](v)
        for ct in (ct_defer, ct_gather))
    np.testing.assert_allclose(float(val_d), float(val_g), rtol=ROUTE_RTOL)
    scale = float(grad_g.abs().max())
    np.testing.assert_allclose(grad_d.numpy(), grad_g.numpy(), rtol=1e-9,
                               atol=1e-11 * scale)


def test_deferred_events_weights_are_marked_stale(pair):
    """Under deferral the events-representation weights lack the rate, so
    after the histogram they are invalid there (a later reader must not take
    them); on the gather route they stay valid."""
    seen = {}
    original = hist.apply_function

    def spying(self):
        original(self)
        for c in self.data.containers:
            seen[c.rate_defer is not None] = c.validity["weights"][
                hash("events")]

    hist.apply_function = spying
    try:
        for ct in pair:
            ct.get_outputs()
    finally:
        hist.apply_function = original
    assert seen == {True: False, False: True}


def test_setup_that_gives_up_leaves_no_matrices(pair, pipeline):
    """``prepare_rate_defer`` returns False when one container of the set
    cannot take the factorized histogram; no container then keeps matrices,
    neither from this call nor from an earlier one (the JAX package leaves
    those of the containers it had already done, ``hist.py:103-203``)."""
    ct_defer, _ = pair
    stage = pipeline["utils.hist"]
    osc = pipeline["osc.prob3"]
    fresh = pipeline.compile(rate_defer=True)
    sc = fresh._trace_data.containers[0]
    assert sc.rate_defer is not None
    plain = Container("plain", device="cpu")
    mixed = ContainerSet("mixed", device="cpu", containers=[sc, plain])
    mixed["output_binning"] = pipeline.output_binning
    assert stage.prepare_rate_defer(mixed, osc.calc_mode,
                                    ["weighted_aeff"]) is False
    assert sc.rate_defer is None
    assert not fresh.rate_deferred
    # and the template then takes the gather route, with the same result
    v = _perturbed(ct_defer)
    assert _deferred_calls(lambda: fresh.get_outputs(v)) == 0
    want = ct_defer.get_outputs(v)
    for m in fresh.get_outputs(v):
        np.testing.assert_allclose(m.hist, want[m.name].hist,
                                   rtol=ROUTE_RTOL, atol=0, err_msg=m.name)
    # the stage holds no deferral state of its own
    assert not any("defer" in name for name in vars(stage))
    assert not any("defer" in name for name in vars(osc))


def test_two_templates_over_one_pipeline_keep_their_routes(pipeline):
    """The hand-off lives on each template's stacked container, so a
    template compiled later without deferral does not switch an earlier
    one's off, nor a later deferred one an earlier gather one's on (the JAX
    package keeps it on the shared stage objects, ``template.py:243-250``)."""
    first = pipeline.compile(rate_defer=True)
    second = pipeline.compile(rate_defer=False)
    third = pipeline.compile(rate_defer=True)
    assert first._trace_data is not third._trace_data
    v = _perturbed(first)
    assert [ct.rate_deferred for ct in (first, second, third)] == [
        True, False, True]
    assert _deferred_calls(lambda: first.get_outputs(v)) == 1
    assert _deferred_calls(lambda: second.get_outputs(v)) == 0
    assert _deferred_calls(lambda: third.get_outputs(v)) == 1
    a, b = first.get_outputs(v), second.get_outputs(v)
    for m in a:
        np.testing.assert_allclose(m.hist, b[m.name].hist, rtol=ROUTE_RTOL,
                                   atol=0, err_msg=m.name)
    # interleaved evaluations leave the eager path as it was
    eager = pipeline.get_outputs()
    first.get_outputs(v)
    again = pipeline.get_outputs()
    for m in eager:
        np.testing.assert_array_equal(again[m.name].hist, m.hist)


def test_deferral_needs_the_contract(pipeline):
    """A traced stage that does not keep the category-scalar weight
    contract switches deferral off (the template then gathers)."""
    stage = pipeline["aeff.aeff"]
    type(stage).stacked_rate_defer_safe = False
    try:
        ct = pipeline.compile(rate_defer=True)
    finally:
        type(stage).stacked_rate_defer_safe = True
    assert ct.stacked and not ct.rate_deferred
