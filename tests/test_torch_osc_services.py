"""
The port's remaining oscillation services (``osc.nusquids`` with 3 and 4
flavours, ``osc.globes``, ``osc.decoherence``, ``osc.external``) and its
service-matrix harness (``pisa_tpu_torch/testing/service_matrix.py``)
against the JAX package's, in fp64 on the CPU (conftest): each service
through both packages' harnesses on the same synthetic containers, in
events and map mode; ``settings/pipeline/sterile_example.cfg`` (maps and the
compiled ``value_and_grad``); the 3+1 variant of the flagship
(``testing/sterile_flagship.py``) on a 20x20 grid at 5% of the events:
eager, compiled, lanes, and its 3-flavour variant against prob3.

Tolerances: weights 1e-10 relative (the 3+1 engine's eigenvalues come from
another algorithm, ``test_torch_sterile.py``); maps 1e-9 of each map's
largest bin (bins whose weight is 1e-10 of the map's carry probabilities at
the 1e-16 round-off of the O(1) ones, and are 1e-9 apart in relative terms
between the JAX package's own eager and compiled runs); the compiled value
1e-9 and gradient entries 1e-8 relative; a template against the same
package's eager run or its lanes against solo runs 1e-12.
"""

import importlib
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.config.parser import parse_pipeline_config as jax_parse
from pisa_tpu.core import binning as jax_binning
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu.testing import service_matrix as JSM
from pisa_tpu_torch import ureg as torch_ureg
from pisa_tpu_torch.config.parser import parse_pipeline_config as torch_parse
from pisa_tpu_torch.core import binning as torch_binning
from pisa_tpu_torch.core.container import Container
from pisa_tpu_torch.core.pipeline import Pipeline as TorchPipeline
from pisa_tpu_torch.testing import service_matrix as TSM
from pisa_tpu_torch.testing.sterile_flagship import sterile_flagship_config
from pisa_tpu_torch.utils.interop import (
    template_inputs_from_jax,
    to_template_order,
)
from test_torch_pipeline import _small_grid_config

WEIGHT_RTOL = 1e-10
MAP_TOL = 1e-9
VALUE_RTOL = 1e-9
GRAD_RTOL = 1e-8
SELF_RTOL = 1e-12
SEED = 42

#: (service module, variant) pairs held against the JAX package
VARIANTS = {
    "nusquids4": "nusquids",
    "nusquids3": "nusquids",
    "globes": "globes",
    "decoherence3": "decoherence",
    "decoherence2": "decoherence",
    "external": "external",
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch's CPU ops on one thread: the test workers share the cores, and
    more threads each only contend for them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variant(package, variant, ureg):
    """The service of `variant` from `package`'s init_test, changed as the
    variant says: 3 flavours, nonzero decoherence, 2-flavour decoherence."""
    mod = importlib.import_module(
        f"{package}.stages.osc.{VARIANTS[variant]}")
    service = mod.init_test()
    if variant == "nusquids3":
        service = mod.nusquids(num_neutrinos=3, params=service.params)
    if variant.startswith("decoherence"):
        for name, value in (("gamma21", 1e-14), ("gamma31", 3e-14),
                            ("gamma32", 2e-14)):
            service.params[name].value = value * ureg.eV
        if variant == "decoherence2":
            service = mod.decoherence(two_flavor=True, params=service.params)
    return service


def _run(variant, mode):
    """{container: weights} of the variant through each package's harness
    on the same synthetic data."""
    out = []
    for package, harness, ureg, kw in (
            ("pisa_tpu", JSM, jax_ureg, {}),
            ("pisa_tpu_torch", TSM, torch_ureg, {"device": "cpu"})):
        service = _variant(package, variant, ureg)
        rng = np.random.RandomState(SEED)
        if mode == "map":
            service.calc_mode = harness.TEST_BINNING
            service.data = harness.make_map_data(service, rng, **kw)
        else:
            service.data = harness.make_events_data(service, rng, **kw)
        service.setup()
        service.run()
        out.append({c.name: np.asarray(c["weights"]) if package == "pisa_tpu"
                    else c["weights"].numpy() for c in service.data})
    return out


@pytest.mark.parametrize("mode", ["events", "map"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_service_matches_jax(variant, mode):
    want, got = _run(variant, mode)
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.all(np.isfinite(got[name]))
        np.testing.assert_allclose(got[name], want[name], rtol=WEIGHT_RTOL,
                                   atol=0, err_msg=name)
    if variant != "external":
        # the oscillation changes something
        assert any(not np.allclose(w, 1.0) for w in got.values())


def test_globes_weight_conventions():
    """CC events: prob_nonsterile = 1 and P(e|mu -> flav); NC events:
    flavour-identity prob_e/prob_mu and the active survival sum, as the
    JAX package (and the reference, globes.py:155-172)."""
    service = TSM.prepare_service("osc", "globes", "events", SEED,
                                  device="cpu")
    service.setup()
    service.run()
    jax_service = _variant("pisa_tpu", "globes", jax_ureg)
    jax_service.data = JSM.make_events_data(jax_service,
                                            np.random.RandomState(SEED))
    jax_service.setup()
    jax_service.run()
    cc, nc = service.data["nutau_cc"], service.data["numubar_nc"]
    np.testing.assert_array_equal(cc["prob_nonsterile"].numpy(), 1.0)
    np.testing.assert_array_equal(nc["prob_e"].numpy(), 0.0)
    np.testing.assert_array_equal(nc["prob_mu"].numpy(), 1.0)
    p4 = nc["probability4"].numpy()
    np.testing.assert_allclose(nc["prob_nonsterile"].numpy(),
                               p4[:, 1, :3].sum(-1), rtol=1e-15)
    assert 0.5 < nc["prob_nonsterile"].numpy().min() < 1.0
    for key in ("prob_e", "prob_mu", "prob_nonsterile"):
        for name in ("nutau_cc", "numubar_nc"):
            np.testing.assert_allclose(
                service.data[name][key].numpy(),
                np.asarray(jax_service.data[name][key]),
                rtol=WEIGHT_RTOL, atol=1e-14, err_msg=f"{name} {key}")


def test_service_matrix_runs_the_ported_services():
    """The port's harness discovers its stages and runs the ported
    oscillation services in both modes; its synthetic containers equal the
    JAX harness's for the same seed."""
    found = TSM.discover_services()
    for name in ("nusquids", "globes", "decoherence", "external", "prob3"):
        assert ("osc", name) in found
    rows = {(s, n): (ev, mp) for s, n, ev, mp in TSM.generate_matrix(
        device="cpu") if s == "osc"}
    for name in ("nusquids", "globes", "decoherence", "external",
                 "two_nu_osc"):
        assert rows[("osc", name)] == ("ok", "ok"), rows[("osc", name)]
    table = TSM.format_markdown_matrix(
        [("osc", "nusquids", "ok", "n/a"), ("osc", "x", "FAIL: boom", "skip")])
    assert "| osc.nusquids | ✓ | — |" in table and "gated" in table
    svc = TSM.prepare_service("osc", "nusquids", "map", 7, device="cpu")
    jsvc = _variant("pisa_tpu", "nusquids4", jax_ureg)
    jsvc.calc_mode = JSM.TEST_BINNING
    jdata = JSM.make_map_data(jsvc, np.random.RandomState(7))
    for c in svc.data:
        for key in c.keys:
            np.testing.assert_array_equal(
                c[key].numpy(), np.asarray(jdata[c.name][key]))


def test_laned_translation_per_container():
    """A value with a lane axis translates between events and a binning on
    a plain container as each lane alone does (the per-container template's
    lanes, which the 3+1 flagship runs)."""
    binning = TSM.TEST_BINNING
    rng = np.random.RandomState(1)
    energy = 10 ** rng.uniform(0.1, 1.9, 50)
    coszen = rng.uniform(-1, 1, 50)
    grid = torch.as_tensor(rng.uniform(size=(3, binning.size, 2)))
    events = torch.as_tensor(rng.uniform(size=(3, 50)))

    def translated(flux, weights, lanes):
        c = Container("numu_cc", representation="events", device="cpu")
        c["true_energy"] = energy
        c["true_coszen"] = coszen
        c.translation_modes["weights"] = "sum"
        c.lanes = lanes
        c.representation = binning
        c["nu_flux"] = flux
        c.representation = "events"
        c["weights"] = weights
        at_events = c["nu_flux"]
        c.representation = binning
        return at_events, c["weights"]

    got_events, got_binned = translated(grid, events, 3)
    assert got_events.shape == (3, 50, 2)
    assert got_binned.shape == (3, binning.size)
    for lane in range(3):
        want_events, want_binned = translated(grid[lane], events[lane], None)
        np.testing.assert_array_equal(got_events[lane].numpy(),
                                      want_events.numpy())
        np.testing.assert_array_equal(got_binned[lane].numpy(),
                                      want_binned.numpy())


# -- sterile_example.cfg ----------------------------------------------------------
STERILE_CFG = "settings/pipeline/sterile_example.cfg"


def _assert_maps(got, want, tol=MAP_TOL):
    assert [m.name for m in got] == [m.name for m in want]
    for m in want:
        ref = np.asarray(m.hist)
        np.testing.assert_allclose(got[m.name].hist, ref, rtol=tol,
                                   atol=tol * np.abs(ref).max(),
                                   err_msg=m.name)


def test_sterile_example_maps_match_jax():
    maps = TorchPipeline(STERILE_CFG, device="cpu").get_outputs()
    _assert_maps(maps, JaxPipeline(STERILE_CFG).get_outputs())


def test_sterile_example_value_and_grad_matches_jax():
    """The compiled mod_chi2 value and gradient (4 free params, the template
    per container: nusquids does not run stacked) at a moved point, with
    the port's eager maps as data for both."""
    pipeline = TorchPipeline(STERILE_CFG, device="cpu")
    data = {m.name: m.hist for m in pipeline.get_outputs()}
    stage = pipeline["osc.nusquids"]
    assert stage.num_neutrinos == 4 and stage.prop_lowpass_cutoff == 0.04
    jax_ct = JaxPipeline(STERILE_CFG).compile()
    _, jax_vg = jax_ct.build_objective(data, "mod_chi2")
    ct = pipeline.compile()
    assert not ct.stacked
    assert sorted(ct.free_names) == sorted(jax_ct.free_names) == sorted(
        ["delta_index", "theta23", "theta24", "deltam41"])
    v0 = np.asarray(jax_ct.current_rescaled_values())
    v = np.clip(v0 + np.random.RandomState(5).uniform(-0.1, 0.1, v0.size),
                0.05, 0.95)
    want_v, want_g = jax_vg(jnp.asarray(v))
    want_g = to_template_order(ct, jax_ct.free_names, np.asarray(want_g))
    vec, _, _ = template_inputs_from_jax(ct, jax_ct.free_names, v,
                                         *jax_ct._current_bounds())
    value_fn, vg = ct.build_objective(data, "mod_chi2")
    got_v, got_g = vg(vec)
    np.testing.assert_allclose(float(got_v), float(want_v), rtol=VALUE_RTOL)
    np.testing.assert_allclose(float(value_fn(vec)), float(want_v),
                               rtol=VALUE_RTOL)
    assert np.all(want_g != 0.0)
    for name, a, b in zip(ct.free_names, got_g.numpy(), want_g):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=0, err_msg=name)


# -- the 3+1 flagship at 5% of the events on a 20x20 grid ---------------------------
def _flagship(directory, **kw):
    return sterile_flagship_config(directory, 20, 0.05, **kw)


def test_sterile_flagship_matches_jax():
    with tempfile.TemporaryDirectory() as d:
        want = JaxPipeline(_flagship(d, parse=jax_parse, binning=jax_binning,
                                     ureg=jax_ureg)).get_outputs()
        got = TorchPipeline(_flagship(d), device="cpu").get_outputs()
    _assert_maps(got, want)


def test_sterile_flagship_template():
    """The 3+1 flagship's compiled template (17 free, per container)
    against its eager run; its lanes (laned translations between the calc
    grid and the events on plain containers) against solo evaluations; its
    gradient in theta24 and theta34 against central differences of the
    template."""
    with tempfile.TemporaryDirectory() as d:
        pipeline = TorchPipeline(_flagship(d), device="cpu")
    maps = pipeline.get_outputs()
    ct = pipeline.compile()
    assert len(ct.free_names) == 17
    assert {"theta24", "theta34"} <= set(ct.free_names)
    assert not ct.stacked
    got = ct.get_outputs()
    for m in maps:
        np.testing.assert_allclose(got[m.name].hist, m.hist, rtol=SELF_RTOL,
                                   atol=0, err_msg=m.name)

    data = {m.name: m.hist for m in maps}
    value_fn, vg = ct.build_objective(data, "mod_chi2")
    v0 = ct.current_rescaled_values()
    rng = np.random.RandomState(3)
    vecs = np.clip(v0 + rng.uniform(-0.05, 0.05, (2, v0.size)), 0.0, 1.0)
    los, his = (torch.as_tensor(x) for x in ct._current_bounds())
    lanes = value_fn.raw_with_data(torch.as_tensor(vecs), los, his, None)
    for i in range(2):
        np.testing.assert_allclose(float(lanes[i]), float(value_fn(vecs[i])),
                                   rtol=SELF_RTOL)
    _, g = vg(vecs[1])
    g = g.numpy()
    assert np.all(np.isfinite(g))
    for name in ("theta24", "theta34"):
        i = ct.free_names.index(name)
        h = 1e-5
        up, down = vecs[1].copy(), vecs[1].copy()
        up[i] += h
        down[i] -= h
        fd = (float(value_fn(up)) - float(value_fn(down))) / (2 * h)
        np.testing.assert_allclose(g[i], fd, rtol=1e-5, err_msg=name)


def test_nusquids_three_flavours_equal_prob3():
    """osc.nusquids with 3 flavours (the general-pack route) and osc.prob3
    (the standard route) compute the same physics: the flagship's maps
    agree to 1e-11 of each map's largest bin (the two formulations'
    round-off), at 5% of the events on the 20x20 grid."""
    with tempfile.TemporaryDirectory() as d:
        config = _flagship(d, num_neutrinos=3)
    want = _small_grid_config(torch_parse, torch_binning, torch_ureg)
    want[("data", "csv_loader")]["fraction_events_to_keep"] = 0.05
    got = TorchPipeline(config, device="cpu").get_outputs()
    _assert_maps(got, TorchPipeline(want, device="cpu").get_outputs(),
                 tol=1e-11)


# -- lanes and the host callable --------------------------------------------------
#: per service, the params given a lane axis and each lane's value (in the
#: param's units)
LANE_PARAMS = {
    "nusquids": {"theta23": (0.70, 0.80), "theta24": (0.10, 0.20),
                 "deltam41": (0.8, 1.6)},
    "globes": {"theta24": (0.10, 0.25), "deltam31": (2.3e-3, 2.6e-3)},
    "decoherence": {"theta23": (0.70, 0.80), "gamma32": (1e-14, 4e-14)},
    "external": {},
}


@pytest.mark.parametrize("name,mode", [
    ("nusquids", "map"), ("globes", "events"), ("decoherence", "map"),
    ("external", "events")])
def test_service_lanes_equal_solo(name, mode):
    """In an evaluation of lanes (as a compiled template runs one: template
    mode, (B, 1) magnitudes, ``data.lanes`` = B) each service gives each
    lane what its solo evaluation gives."""
    from pisa_tpu_torch.units import Quantity

    service = TSM.prepare_service("osc", name, mode, SEED, device="cpu")
    service.setup()
    data = service.data
    state = data.state()
    params = LANE_PARAMS[name]
    service._template_mode = True
    try:
        data.lanes = 2
        for pname, values in params.items():
            p = service.params[pname]
            p._value = Quantity(torch.tensor(values, dtype=torch.float64)[
                :, None], p.value.units)
        service.run()
        lanes = {c.name: c["weights"].clone() for c in data.containers}
        data.lanes = None
        for lane in range(2):
            data.set_state(state)
            for pname, values in params.items():
                p = service.params[pname]
                p._value = Quantity(torch.tensor(values[lane],
                                                 dtype=torch.float64),
                                    p.value.units)
            service.run()
            for c in data.containers:
                got = lanes[c.name]
                assert got.shape[0] == 2
                np.testing.assert_allclose(got[lane].numpy(),
                                           c["weights"].numpy(),
                                           rtol=SELF_RTOL, atol=0,
                                           err_msg=f"{c.name} lane {lane}")
    finally:
        service._template_mode = False
        data.lanes = None


def test_external_calls_its_callable_once_per_setup():
    """The host callable runs once per container (or link) for a callable
    and its params, so that a traced evaluation reads nothing on the host;
    a new callable or new params call it again."""
    service = TSM.prepare_service("osc", "external", "map", SEED,
                                  device="cpu")
    calls = []
    dummy = service.osc_prob

    def counted(*args, **kwargs):
        calls.append(args[3])
        return dummy(*args, **kwargs)

    service.osc_prob = counted
    service.setup()
    service._template_mode = True
    try:
        for _ in range(3):
            service.run()
        assert sorted(calls) == [-1, 1]  # the nu and nubar links, once
        service.external_params = {}
        service.osc_prob = lambda *a, **k: counted(*a, **k)
        service.run()
        assert len(calls) == 4
    finally:
        service._template_mode = False
