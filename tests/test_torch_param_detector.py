"""
The parameterized-detector path (``testing/param_detector.py``: toy events
-> barr_simple -> prob3 -> aeff.param -> reco.simple_param ->
reco.resolutions -> utils.hist -> utils.fix_error, 4 free) against the JAX
package, in fp64 on the CPU (conftest), at ``small=True`` (2,000 events a
category on ``calc_grid_coarse``): the eager maps and errors, the reco
variables bit for bit, the compiled template's maps, and the compiled
``mod_chi2`` value and gradient at a moved point; then, in the port alone,
the errors that fix_error freezes on both routes, hist's options on a
stacked container with padded categories, and hist's binned calc mode with
lanes.

Tolerances: maps and errors 1e-10 of each map's largest bin; the compiled
value 1e-9 and each gradient entry 1e-8 relative (as
``tests/test_torch_flux_xsec.py``); a template against the same package's
eager run 1e-12; the random streams exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pisa_tpu.config.parser import parse_pipeline_config as jax_parse
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu_torch.core import stacking
from pisa_tpu_torch.core.container import Container, ContainerSet
from pisa_tpu_torch.core.pipeline import Pipeline
from pisa_tpu_torch.stages.utils.hist import hist
from pisa_tpu_torch.testing import service_matrix as TSM
from pisa_tpu_torch.testing.param_detector import param_detector_config
from pisa_tpu_torch.utils.interop import (
    template_inputs_from_jax,
    to_template_order,
)

MAP_RTOL = 1e-10
VALUE_RTOL = 1e-9
VG_RTOL = 1e-8
SELF_RTOL = 1e-12
FREE = ["delta_index", "theta23", "deltam31", "aeff_scale"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_maps(got, want, label):
    """Each map's bins (and errors) within MAP_RTOL of its largest."""
    for name, (hist, err) in want.items():
        g_hist, g_err = got[name]
        assert np.all(np.isfinite(g_hist)) and np.all(np.isfinite(g_err))
        np.testing.assert_allclose(g_hist, hist, rtol=0,
                                   atol=MAP_RTOL * np.abs(hist).max(),
                                   err_msg=f"{label} {name}")
        np.testing.assert_allclose(g_err, err, rtol=0,
                                   atol=MAP_RTOL * np.abs(err).max(),
                                   err_msg=f"{label} {name} errors")


def _eager_maps(maps):
    return {m.name: (np.asarray(m.hist).ravel(),
                     np.asarray(m.error_hist).ravel()) for m in maps}


def _template_maps(out):
    return {name: (np.asarray(h).ravel(), np.asarray(out["error"][name])
                   .ravel()) for name, h in out["hist"].items()}


def test_param_detector_matches_jax():
    """The JAX package's pipeline is built once here (its compile dominates
    this file's time). Also shows the JAX package's fix_error fault that
    the port does not copy: its compiled template's errors follow theta23,
    where its eager pipeline's stay frozen."""
    pipeline = Pipeline(param_detector_config(small=True), device="cpu")
    jax_pipeline = JaxPipeline(param_detector_config(small=True,
                                                     parse=jax_parse))
    got = pipeline.get_outputs()
    want = jax_pipeline.get_outputs()
    assert [m.name for m in got] == [m.name for m in want]
    assert len(got) == 12 and got[0].hist.shape == (10, 10, 2)
    nominal = _eager_maps(want)
    _assert_maps(_eager_maps(got), nominal, "eager")

    # the reco variables the two packages drew, after reco.resolutions
    for c in pipeline.data:
        jc = jax_pipeline.data[c.name]
        c.representation = jc.representation = "events"
        assert c.size == 2000
        for key in ("reco_energy", "reco_coszen", "pid"):
            np.testing.assert_array_equal(c[key].numpy(), np.asarray(jc[key]),
                                          err_msg=f"{c.name} {key}")
        assert set(np.unique(c["pid"].numpy())) == {-1.0, 1.0}

    ct = pipeline.compile()
    assert not ct.stacked and ct.free_names == FREE
    compiled = _template_maps(ct(ct.current_rescaled_values()))
    _assert_maps(compiled, nominal, "compiled")

    data = {m.name: m.hist for m in got}
    jax_ct = jax_pipeline.compile()
    _, jax_vg = jax_ct.build_objective(data, "mod_chi2")
    v0 = np.asarray(jax_ct.current_rescaled_values())
    v = np.clip(v0 + np.random.RandomState(5).uniform(-0.05, 0.05, v0.size),
                0.02, 0.98)
    want_value, want_grad = jax_vg(jnp.asarray(v))
    want_grad = to_template_order(ct, jax_ct.free_names,
                                  np.asarray(want_grad))
    vec, _, _ = template_inputs_from_jax(
        ct, jax_ct.free_names, v,
        *[np.asarray(b) for b in jax_ct._current_bounds()])
    _, vg = ct.build_objective(data, "mod_chi2")
    value, grad = vg(vec)
    assert abs(float(value) - float(want_value)) <= VALUE_RTOL * abs(
        float(want_value))
    assert np.all(np.isfinite(want_grad)) and np.all(want_grad != 0)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=VG_RTOL, atol=0)

    # the JAX package's fault: at theta23 moved, its compiled template's
    # errors are the moved sumw2, its eager pipeline's the frozen nominal
    moved = v0.copy()
    moved[jax_ct.free_names.index("theta23")] += 0.05
    jax_out = jax_ct(jnp.asarray(moved))
    worst = max(float(np.abs(np.asarray(jax_out["error"][n]) - err).max()
                      / err.max()) for n, (_, err) in nominal.items())
    assert worst > 1e-3


def test_fix_error_freezes_on_both_routes():
    """The port's errors at theta23 moved are the ones of the first
    evaluation after set-up (the nominal point here), in a compiled
    template and on the eager route after it; a new set-up takes them
    anew, at the point it then runs."""
    pipeline = Pipeline(param_detector_config(small=True), device="cpu")
    nominal = _eager_maps(pipeline.get_outputs())
    ct = pipeline.compile()
    v = ct.current_rescaled_values()
    v[ct.free_names.index("theta23")] += 0.05
    out = ct(v)
    moved = {name: (np.asarray(h), nominal[name][1])
             for name, h in out["hist"].items()}
    _assert_maps(_template_maps(out), moved, "compiled, moved")
    assert any(np.abs(h - nominal[n][0]).max() > 1e-3 * nominal[n][0].max()
               for n, (h, _) in moved.items())
    pipeline.params["theta23"]._rescaled_value = v[1]
    _assert_maps(_eager_maps(pipeline.get_outputs()), moved, "eager, moved")

    pipeline.setup()
    retaken = _eager_maps(pipeline.get_outputs())
    assert any(np.abs(err - nominal[n][1]).max() > 1e-3 * err.max()
               for n, (_, err) in retaken.items())
    _assert_maps(_template_maps(pipeline.compile()(v)), retaken,
                 "compiled after a new set-up")


def _unequal_events(sizes, seed=4):
    """Containers of `sizes` events (unequal, so that a stacked container
    pads) with the harness's synthetic coordinates and weights."""
    rng = np.random.RandomState(seed)
    containers = []
    for name, n in sizes.items():
        c = Container(name, representation="events", device="cpu")
        for key in ("true_energy", "true_coszen", "weights", "unc_weights"):
            c[key] = TSM.key_value(key, rng, n) * (
                rng.uniform(0.5, 2.0, n) if key == "weights" else 1.0)
        containers.append(c)
    cs = ContainerSet("test", device="cpu", containers=containers)
    cs["output_binning"] = TSM.TEST_BINNING
    return cs


@pytest.mark.parametrize("options", [{"unweighted": True},
                                     {"apply_unc_weights": True}])
def test_hist_options_on_a_stacked_container(options):
    """hist's options on a category-stacked container whose categories
    differ in size (so the stacked one pads): each category's histogram,
    errors and bin_unc2 are the per-container route's; with unit weights
    a bin counts the category's events in it, the padded slots nothing."""
    sizes = {"nue_cc": 30, "numu_cc": 55, "nutau_nc": 41}
    service = hist(calc_mode="events", error_method="sumw2", **options)
    service.data = _unequal_events(sizes)
    service.setup()
    service.run()
    want = {c.name: {k: c[k].numpy() for k in ("weights", "errors",
                                                "bin_unc2")}
            for c in service.data}
    stacked = stacking.build_stacked_set(
        _unequal_events(sizes), coord_keys=set(TSM.TEST_BINNING.names))
    (sc,) = stacked.containers
    assert sc.n_pad == 55
    service.data = stacked
    service.prepare_stacked(stacked)
    service.run()
    sc.representation = TSM.TEST_BINNING
    for key in ("weights", "errors", "bin_unc2"):
        got = sc.expanded(key)
        for i, name in enumerate(sc.cat_names):
            np.testing.assert_allclose(got[i].numpy(), want[name][key],
                                       rtol=SELF_RTOL, atol=0,
                                       err_msg=f"{name} {key}")
    if options.get("unweighted"):
        for name, n in sizes.items():
            counts = want[name]["weights"]
            np.testing.assert_array_equal(counts, np.round(counts))
            assert 0 < counts.sum() <= n


def test_binned_calc_hist_takes_lanes():
    """hist in the binned calc mode (the weights histogrammed on
    calc_grid_coarse, then mapped to reco_binning by the events' joint
    histogram): a compiled template's evaluation of 3 lanes gives each
    lane's single evaluation, sumw2 errors included."""
    cfg = param_detector_config(small=True)
    section = cfg[("utils", "hist")]
    section["calc_mode"] = cfg[("osc", "prob3")]["calc_mode"]
    pipeline = Pipeline(cfg, device="cpu")
    hist = pipeline.stages[-2]
    assert hist.is_map and not hist.stacked_ok()
    ct = pipeline.compile()
    v0 = ct.current_rescaled_values()
    vecs = np.clip(v0 + np.random.RandomState(2).uniform(-0.05, 0.05,
                                                         (3, v0.size)),
                   0.02, 0.98)
    lanes = ct._evaluate(ct._magnitudes_from_rescaled(vecs), lanes=3)
    for b, vec in enumerate(vecs):
        single = ct(vec)
        for name, h in single["hist"].items():
            np.testing.assert_allclose(lanes["hist"][name][b].detach(), h,
                                       rtol=SELF_RTOL, atol=0, err_msg=name)
            np.testing.assert_allclose(lanes["error"][name][b].detach(),
                                       single["error"][name],
                                       rtol=SELF_RTOL, atol=0, err_msg=name)
