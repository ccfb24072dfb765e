"""
The port's category stacking (``pisa_tpu_torch/core/stacking.py`` and the
stacked paths of the flagship's stages) against the JAX package.

The flagship ``settings/pipeline/IceCube_3y_neutrinos.cfg`` with the
``true_allsky_fine`` grid cut to 20x20 (tests/test_torch_pipeline.py) and all
240k events, fp64 on the CPU (conftest). The JAX template is built once, by
its default route (stacked, rate deferral on); the port compiles the same
pipeline three ways (stacked with deferral, stacked without, per container)
and each must reproduce it:

- templates to 1e-9 relative per bin (TEMPLATE_RTOL);
- the ``mod_chi2`` value to 1e-9 relative and every gradient entry to 1e-7
  relative plus 1e-9 of max|g| (the packages differ in operation order
  only), at the nominal and the perturbed point of
  tests/test_torch_template.py;
- ``scan_totals`` to 1e-9 relative.

Then the stacking primitives on a toy set with unequal category sizes (the
cases of tests/test_stacking.py:144-240), with numpy-seeded inputs.
"""

import logging

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
from pisa_tpu_torch.core import translation
from pisa_tpu_torch.core.binning import MultiDimBinning, OneDimBinning
from pisa_tpu_torch.core.container import Container, ContainerSet
from pisa_tpu_torch.core.pipeline import Pipeline as TorchPipeline
from pisa_tpu_torch.core.stacking import StackingError, build_stacked_set
from pisa_tpu_torch.ops.flux import barr
from pisa_tpu_torch.ops.osc import chain
from pisa_tpu_torch.utils.interop import (
    template_inputs_from_jax,
    to_template_order,
)
from test_torch_pipeline import _small_grid_config
from test_torch_template import _as_arrays, _points

TEMPLATE_RTOL = 1e-9
VALUE_RTOL = 1e-9
GRAD_RTOL = 1e-7
GRAD_ATOL_FRACTION = 1e-9  # of max |gradient|
SCAN_RTOL = 1e-9

ROUTES = {
    "stacked+deferral": dict(stack=True, rate_defer=True),
    "stacked": dict(stack=True, rate_defer=False),
    "unstacked": dict(stack=False),
}


@pytest.fixture(scope="module")
def templates():
    """(JAX template, port pipeline, {route: port template}, JAX nominal
    Asimov data). The three port templates share one pipeline."""
    jax_ct = JaxPipeline(
        _small_grid_config(jax_parse, jax_binning, jax_ureg)).compile()
    assert jax_ct._trace_data is not jax_ct.pipeline.data  # stacked
    pipeline = TorchPipeline(
        _small_grid_config(torch_parse, torch_binning, torch_ureg),
        device="cpu",
    )
    cts = {route: pipeline.compile(**kw) for route, kw in ROUTES.items()}
    data = jax_ct.get_outputs(jax_ct.current_rescaled_values())
    return jax_ct, pipeline, cts, data


@pytest.fixture(scope="module")
def jax_value_and_grad(templates):
    jax_ct, _, _, data = templates
    return jax_ct.build_objective(_as_arrays(data), "mod_chi2")[1]


def test_routes_are_what_they_say(templates):
    _, pipeline, cts, _ = templates
    assert cts["stacked+deferral"].stacked
    assert cts["stacked+deferral"].rate_deferred
    assert cts["stacked"].stacked and not cts["stacked"].rate_deferred
    assert not cts["unstacked"].stacked
    assert not cts["unstacked"].rate_deferred
    # the default route stacks; whether it defers is the measured default
    from pisa_tpu_torch.core.template import RATE_DEFER_DEFAULT

    default = pipeline.compile()
    assert default.stacked
    assert default.rate_deferred is RATE_DEFER_DEFAULT
    sc = cts["stacked"]._trace_data.containers[0]
    assert sc.cat_names == pipeline.data.names and sc.n_pad == 20000


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("point", ["nominal", "perturbed"])
def test_template_matches_jax(templates, route, point):
    jax_ct, _, cts, _ = templates
    ct = cts[route]
    v = _points(jax_ct)[point]
    want = jax_ct.get_outputs(v)
    got = ct.get_outputs(to_template_order(ct, jax_ct.free_names, v))
    assert [m.name for m in got] == [m.name for m in want]
    for m in want:
        np.testing.assert_allclose(got[m.name].hist, np.asarray(m.hist),
                                   rtol=TEMPLATE_RTOL, atol=0,
                                   err_msg=m.name)
        np.testing.assert_allclose(got[m.name].error_hist,
                                   np.asarray(m.error_hist),
                                   rtol=TEMPLATE_RTOL, atol=0,
                                   err_msg=m.name)


@pytest.mark.parametrize("route", ROUTES)
def test_value_and_grad_matches_jax(templates, jax_value_and_grad, route):
    """mod_chi2 with priors: value and all 15 gradient entries off the
    minimum; at the minimum the values agree and both gradients are
    round-off next to the off-minimum one."""
    jax_ct, _, cts, data = templates
    ct = cts[route]
    value_fn, vg = ct.build_objective(_as_arrays(data), "mod_chi2")
    los, his = jax_ct._current_bounds()
    results = {}
    for label, v in _points(jax_ct).items():
        want_v, want_g = jax_value_and_grad(jnp.asarray(v))
        want_g = to_template_order(ct, jax_ct.free_names, want_g)
        vec, _, _ = template_inputs_from_jax(ct, jax_ct.free_names, v, los,
                                             his)
        got_v, got_g = vg(vec)
        np.testing.assert_allclose(float(got_v), float(want_v),
                                   rtol=VALUE_RTOL, atol=0)
        np.testing.assert_allclose(float(value_fn(vec)), float(want_v),
                                   rtol=VALUE_RTOL, atol=0)
        results[label] = (got_g.numpy(), want_g)
    got_g, want_g = results["perturbed"]
    scale = np.abs(want_g).max()
    assert np.all(want_g != 0.0)
    for name, a, b in zip(ct.free_names, got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_FRACTION * scale,
                                   err_msg=name)
    for g in results["nominal"]:
        assert np.abs(g).max() < 1e-8 * scale


def test_scan_totals_match_jax(templates):
    """tests/test_stacking.py:104: four seeded vectors, every route."""
    jax_ct, _, cts, _ = templates
    rng = np.random.RandomState(7)
    vecs = rng.uniform(0.1, 0.9, size=(4, len(jax_ct.free_names)))
    want = np.asarray(jax_ct.scan_totals(vecs))
    for route, ct in cts.items():
        port_vecs = np.stack([to_template_order(ct, jax_ct.free_names, v)
                              for v in vecs])
        got = ct.scan_totals(port_vecs)
        assert isinstance(got, torch.Tensor) and got.shape == (4,)
        np.testing.assert_allclose(got.numpy(), want, rtol=SCAN_RTOL,
                                   atol=0, err_msg=route)


def test_stacked_gradient_launches(templates):
    """The stacked routes ask for the same passes as the per-container
    one: per value_and_grad two primal and, by prob3's default, two
    multitangent (on the CPU the wrappers take the plain versions, so this
    counts their calls)."""
    jax_ct, _, cts, data = templates
    calls = {"primal": 0, "tangent": 0, "multitangent": 0}
    saved = (chain.chain_probs, chain.chain_tangent, chain.chain_multitangent)

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    chain.chain_probs = count("primal", saved[0])
    chain.chain_tangent = count("tangent", saved[1])
    chain.chain_multitangent = count("multitangent", saved[2])
    try:
        for route, ct in cts.items():
            _, vg = ct.build_objective(_as_arrays(data), "mod_chi2")
            for name in calls:
                calls[name] = 0
            vg(to_template_order(ct, jax_ct.free_names,
                                 _points(jax_ct)["perturbed"]))
            assert calls == {"primal": 2, "tangent": 0,
                             "multitangent": 2}, route
    finally:
        chain.chain_probs, chain.chain_tangent, chain.chain_multitangent = (
            saved)


def test_evaluated_path_stays_on_the_vector_device(templates):
    """The magnitudes, the oscillation pack and its Jacobian are float64
    tensors on the rescaled vector's device (here the CPU; on the card
    tests/test_torch_template.py checks that no CPU tensor appears)."""
    _, pipeline, cts, _ = templates
    ct = cts["stacked"]
    vec = torch.as_tensor(ct.current_rescaled_values())
    mags = ct._magnitudes_from_rescaled(vec)
    assert len(mags) == 15
    for mag in mags:
        assert isinstance(mag, torch.Tensor) and mag.dim() == 0
        assert mag.device == vec.device and mag.dtype == torch.float64
    by_name = dict(zip(ct.free_names, mags))
    theta = chain.theta_tensor(
        [by_name.get(n, 0.1) for n in pipeline["osc.prob3"]._THETA_NAMES])
    assert theta.device == vec.device and theta.shape == (6,)
    for nubar in (1, -1):
        pack = chain.theta_to_pvec(theta, nubar)
        jac = torch.func.jacfwd(
            lambda t: chain.theta_to_pvec(t, nubar))(theta)
        assert pack.device == jac.device == vec.device
        assert pack.shape == (57,) and jac.shape == (57, 6)
    # a vector on another device is refused, never moved
    with pytest.raises(ValueError, match="lives on"):
        ct._magnitudes_from_rescaled(torch.zeros(15, device="meta"))


def test_stage_that_cannot_stack_falls_back_and_says_so(templates):
    """With hoisting off the loader is a traced stage, and it cannot run on
    a stacked container: the template runs per container, logs why and
    reports it; the values are the same."""
    jax_ct, pipeline, cts, _ = templates
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("pisa_tpu_torch")  # does not propagate
    logger.addHandler(handler)
    try:
        ct = pipeline.compile(hoist=False)
    finally:
        logger.removeHandler(handler)
    assert not ct.stacked and not ct.rate_deferred
    assert ct._hoisted_stages == []
    assert any(r.levelno == logging.WARNING and "stacking off"
               in r.getMessage() and "csv_loader" in r.getMessage()
               for r in records)
    v = to_template_order(ct, jax_ct.free_names, _points(jax_ct)["perturbed"])
    want = cts["stacked"].get_outputs(v)
    for m in ct.get_outputs(v):
        np.testing.assert_allclose(m.hist, want[m.name].hist, rtol=1e-12,
                                   atol=0, err_msg=m.name)


# ---------------------------------------------------------------------------
# primitives, on a toy set with unequal category sizes (padding)
# ---------------------------------------------------------------------------


def _toy_binning():
    x = OneDimBinning(
        "x", bin_edges=np.linspace(0.0, 1.0, 5) * torch_ureg.dimensionless)
    y = OneDimBinning(
        "y", bin_edges=np.linspace(-1.0, 1.0, 4) * torch_ureg.dimensionless)
    return MultiDimBinning([x, y])


def _toy_set():
    rng = np.random.RandomState(3)
    cs = ContainerSet("toy", device="cpu")
    for name, n in {"a": 7, "b": 12, "c": 4}.items():
        c = Container(name, representation="events", device="cpu")
        c["x"] = rng.uniform(-0.2, 1.2, n)  # some out of range
        c["y"] = rng.uniform(-1.0, 1.0, n)
        c["weights"] = rng.uniform(0.5, 2.0, n)
        c["count"] = rng.randint(0, 5, n)
        c.set_aux_data("nubar", 1 if name != "b" else -1)
        c.set_aux_data("flav", 1)
        cs.add_container(c)
    return cs


def test_build_stacked_set_pads_and_keeps_aux():
    cs = _toy_set()
    sc = build_stacked_set(cs, coord_keys=("x", "y")).containers[0]
    assert sc.is_stacked and sc.n_pad == 12 and sc.shape == (3, 12)
    assert sc.cat_names == ["a", "b", "c"]
    # coordinates pad with NaN, other floats and ints with 0
    assert torch.isnan(sc["x"][0, 7:]).all() and torch.isnan(sc["y"][2, 4:]).all()
    assert (sc["weights"][0, 7:] == 0).all() and (sc["count"][2, 4:] == 0).all()
    assert sc["count"].dtype == torch.int64
    for i, c in enumerate(cs.containers):
        n = c.size
        assert torch.equal(sc["weights"][i, :n], c["weights"])
    # per-category aux as (C,) arrays, shared aux as the scalar
    np.testing.assert_array_equal(sc.cat_aux("nubar"), [1, -1, 1])
    assert sc["flav"] == 1
    np.testing.assert_array_equal(sc.cat_aux("flav"), [1, 1, 1])
    # the source set is not touched
    assert [c.size for c in cs.containers] == [7, 12, 4]


def test_stacked_histogram_unequal_sizes():
    cs = _toy_set()
    binning = _toy_binning()
    sc = build_stacked_set(cs, coord_keys=("x", "y")).containers[0]
    w = sc["weights"]
    chans = torch.stack([w, w * w], dim=-1)
    hist_mm = sc.stacked_histogram(w, binning)  # the cached one-hot
    assert sc.cached_hist_matrix(binning).shape == (3, 12, binning.size)
    hist_avg = sc.stacked_histogram(w, binning, averaged=True)
    hist_ch = sc.stacked_histogram(chans, binning)
    for i, c in enumerate(cs.containers):
        sample = [c["x"], c["y"]]
        ref = translation.histogram(sample, c["weights"], binning)
        np.testing.assert_allclose(hist_mm[i], ref, rtol=1e-12, atol=0)
        np.testing.assert_allclose(hist_ch[i, :, 0], ref, rtol=1e-12, atol=0)
        np.testing.assert_allclose(
            hist_avg[i],
            translation.histogram(sample, c["weights"], binning,
                                  averaged=True),
            rtol=1e-12, atol=0)
    # beyond the one-hot budget: one offset scatter-add, the same result
    from pisa_tpu_torch.core import stacking

    saved = stacking._HIST_MATRIX_MAX_ELEMS
    stacking._HIST_MATRIX_MAX_ELEMS = 1
    try:
        sc2 = build_stacked_set(cs, coord_keys=("x", "y")).containers[0]
        assert sc2.cached_hist_matrix(binning) is None
        np.testing.assert_allclose(sc2.stacked_histogram(w, binning), hist_mm,
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(sc2.stacked_histogram(chans, binning),
                                   hist_ch, rtol=1e-12, atol=0)
    finally:
        stacking._HIST_MATRIX_MAX_ELEMS = saved


@pytest.mark.parametrize("rows_kind", ["grouped", "cat", "shared"])
def test_stacked_binned_to_array_rows(rows_kind):
    """A binned value read in the events representation is gathered per
    category through its rows map; padded and out-of-range slots get 0."""
    cs = _toy_set()
    binning = _toy_binning()
    sc = build_stacked_set(cs, coord_keys=("x", "y")).containers[0]
    rng = np.random.RandomState(5)
    grp = (np.asarray(sc.cat_aux("nubar")) < 0).astype(np.int32)
    sc.representation = binning
    if rows_kind == "grouped":
        vals = rng.uniform(0.0, 1.0, (2, binning.size))
        sc.set_stacked("probs", vals, rows=grp)
        per_cat = vals[grp]
    elif rows_kind == "cat":
        vals = rng.uniform(0.0, 1.0, (3, binning.size))
        sc["probs"] = vals
        per_cat = vals
    else:
        vals = rng.uniform(0.0, 1.0, binning.size)
        sc["probs"] = vals
        per_cat = np.stack([vals] * 3)
    assert sc.expanded("probs").shape[-1] == binning.size
    sc.representation = "events"
    got = sc["probs"]  # auto-translate: one gather
    assert got.shape == (3, sc.n_pad)
    assert sc.rows[("probs", hash("events"))] == "cat"
    for i, c in enumerate(cs.containers):
        ref = translation.lookup([c["x"], c["y"]],
                                 torch.as_tensor(per_cat[i]), binning)
        n = c.size
        np.testing.assert_allclose(got[i, :n], ref, rtol=0, atol=0)
        assert (got[i, n:] == 0).all()
    # the gather's reverse pass adds the event cotangents into the cells
    table = torch.as_tensor(np.asarray(per_cat), dtype=torch.float64
                            ).requires_grad_(True)
    out = sc._stacked_binned_to_array(table, "cat", binning)
    (grad,) = torch.autograd.grad(out.sum(), table)
    idx = sc.cached_flat_indices(binning)
    for i in range(3):
        counts = np.bincount(idx[i].numpy(), minlength=binning.size + 1)
        np.testing.assert_array_equal(grad[i].numpy(), counts[:binning.size])


def test_stacked_writes_infer_or_check_rows():
    cs = _toy_set()
    binning = _toy_binning()
    sc = build_stacked_set(cs, coord_keys=("x", "y")).containers[0]
    with pytest.raises(ValueError, match="Stacked events write"):
        sc["weights"] = np.ones(12)
    sc.representation = binning
    sc["a"] = np.ones((3,) + tuple(binning.shape))  # unflattened, per cat
    assert sc["a"].shape == (3, binning.size)
    sc["b"] = np.ones(tuple(binning.shape))  # unflattened, shared
    assert sc["b"].shape == (binning.size,)
    assert sc.rows[("a", hash(binning))] == "cat"
    assert sc.rows[("b", hash(binning))] is None
    with pytest.raises(ValueError, match="Ambiguous"):
        sc["c"] = np.ones((2, binning.size))
    with pytest.raises(ValueError, match="rows must be"):
        sc.set_stacked("c", np.ones((2, binning.size)), rows=[0, 1])


def test_state_covers_rows_and_deferred_rate():
    """A template evaluation restores the stacked container through
    state()/set_state(): the rows maps and the deferred rate with the
    tensors."""
    cs = _toy_set()
    binning = _toy_binning()
    sc = build_stacked_set(cs, coord_keys=("x", "y")).containers[0]
    state = sc.state()
    sc.representation = binning
    sc.set_stacked("probs", np.ones((2, binning.size)), rows=[0, 1, 0])
    sc.deferred_rate = {"rate": torch.ones(2, binning.size), "rows": [0, 1, 0]}
    assert ("probs", hash(binning)) in sc.rows
    sc.set_state(state)
    assert "probs" not in sc and ("probs", hash(binning)) not in sc.rows
    assert sc.deferred_rate is None and sc.representation == "events"


def test_stacking_rejects_mixed_keys_and_links():
    cs = _toy_set()
    cs.containers[1]["extra"] = np.ones(12)
    with pytest.raises(StackingError, match="differing key sets"):
        build_stacked_set(cs, coord_keys=("x", "y"))
    # a stage's helper key can be left out
    sc = build_stacked_set(cs, coord_keys=("x", "y"),
                           exclude_keys=("extra",)).containers[0]
    assert "extra" not in sc
    cs = _toy_set()
    cs.representation = _toy_binning()
    cs.link_containers("ac", ["a", "c"])
    with pytest.raises(StackingError, match="linked"):
        build_stacked_set(cs)
    one = ContainerSet("one", device="cpu", containers=cs.containers[:1])
    with pytest.raises(StackingError, match="fewer than 2"):
        build_stacked_set(one)


def test_binned_values_dedup_to_groups():
    """Binned tensors that containers share (by identity, as linked
    containers do, or by value) become one row per group."""
    cs = _toy_set()
    binning = _toy_binning()
    rng = np.random.RandomState(11)
    cs.representation = binning
    cs.link_containers("ac", ["a", "c"])
    shared = rng.uniform(size=binning.size)
    for c in cs:
        c["grid_flux"] = shared if c.name == "ac" else shared + 1.0
    cs.unlink_containers()
    assert cs["a"]["grid_flux"] is cs["c"]["grid_flux"]
    for c in cs.containers:
        c["same"] = np.arange(binning.size, dtype=float)  # equal by value
    cs.representation = "events"
    sc = build_stacked_set(cs, coord_keys=("x", "y")).containers[0]
    h = hash(binning)
    np.testing.assert_array_equal(sc.rows[("grid_flux", h)], [0, 1, 0])
    assert sc.rows[("same", h)] is None
    sc.representation = binning
    assert sc["grid_flux"].shape == (2, binning.size)
    assert sc.expanded("grid_flux").shape == (3, binning.size)
    assert sc["same"].shape == (binning.size,)


def test_barr_factored_fields_match_direct():
    """The precomputable Barr fields (``ops/flux/barr.py``, factored forms)
    reproduce the direct evaluation, for numbers and 0-d tensors."""
    rng = np.random.RandomState(11)
    e = torch.as_tensor(rng.uniform(1.0, 200.0, 300))
    cz = torch.as_tensor(rng.uniform(-1.0, 1.0, 300))
    for sys_val in (-1.7, 0.0, 0.9, torch.tensor(0.4, dtype=torch.float64)):
        for nubar in (1, -1):
            for flav in (0, 1):
                direct = barr.mod_ratio_nubar(nubar, flav, e, cz, sys_val)
                fact = barr.mod_ratio_nubar_from_field(
                    nubar, barr.nubar_mod_field(flav, e, cz), sys_val)
                np.testing.assert_allclose(fact, direct, rtol=1e-13)
        for flav in (0, 1):
            direct = barr.mod_ratio_uphor(flav, e, cz, sys_val)
            fact = barr.mod_ratio_uphor_from_field(
                barr.uphor_mod_field(flav, e, cz), sys_val)
            np.testing.assert_allclose(fact, direct, rtol=1e-13, atol=1e-15)
    for delta in (-0.3, 0.12):
        direct = barr.spectral_index_scale(e, 24.09, delta)
        fact = barr.spectral_index_scale_from_log(torch.log(e / 24.09), delta)
        np.testing.assert_allclose(fact, direct, rtol=1e-13)
