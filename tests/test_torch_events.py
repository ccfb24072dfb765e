"""
The port's event path against the JAX package's, in fp64 on the CPU
(conftest): ``core/events_pi.py`` (loading, the flavour split, the legacy
flux fix, subsampling, cuts, ``keep_inbounds``), ``core/events.py``
(``Events``, ``Data``, histograms, cuts), ``scripts/make_toy_events.py``,
the ``data.simple_data_loader`` service through both service-matrix
harnesses, and the maps of the pipelines that read the repo's HDF5 events
file (``example``, ``fast_example``, ``varbin_example``) or make their own
events (``osc_example``, ``toy_flux_fit``).

Tolerances: event arrays and toy events equal; histograms 1e-12 relative
(the same sums in another order); maps 1e-9 of each map's largest bin (the
prob3 chain's round-off, as in ``test_torch_osc_services.py``).
"""

import numpy as np
import pytest
import torch

from pisa_tpu.core import binning as jax_binning
from pisa_tpu.core import events as jax_events
from pisa_tpu.core import events_pi as jax_events_pi
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu.core.container import ContainerSet as JaxContainerSet
from pisa_tpu.scripts.make_toy_events import make_toy_events as jax_toy
from pisa_tpu.stages.data import simple_data_loader as jax_loader
from pisa_tpu.testing import service_matrix as JSM
from pisa_tpu_torch.core import binning as torch_binning
from pisa_tpu_torch.core import events as torch_events
from pisa_tpu_torch.core import events_pi as torch_events_pi
from pisa_tpu_torch.core.container import ContainerSet
from pisa_tpu_torch.core.distribution_maker import DistributionMaker
from pisa_tpu_torch.core.pipeline import Pipeline as TorchPipeline
from pisa_tpu_torch.scripts.make_toy_events import make_toy_events
from pisa_tpu_torch.stages.data import simple_data_loader as torch_loader
from pisa_tpu_torch.testing import service_matrix as TSM

HIST_RTOL = 1e-12
MAP_TOL = 1e-9
EVENTS = jax_loader.init_test().events_file[0]
DATA_DICT = {
    "true_energy": "true_energy",
    "true_coszen": "true_coszen",
    "reco_energy": "reco_energy",
    "pid": "pid",
    "nu_flux_nominal": ["nominal_nue_flux", "nominal_numu_flux"],
}


# Torch's CPU ops run on one thread in every process that imports this
# module, for the whole session. The test workers share the machine's
# cores; with each worker's OpenMP team at one thread per core the teams
# spin on one another, and tests made of many small ops ran up to 30x
# slower, which tests moving with the schedule (tests/ under the Tier-1
# command, 6 workers on 8 cores: 2,588 s with torch's default threads, 653
# s with this line). Each worker imports every test module while it
# collects, so this holds in all of them; a file run alone keeps torch's
# default.
torch.set_num_threads(1)


def assert_events_equal(got, want):
    assert list(got) == list(want)
    for key in want:
        assert list(got[key]) == list(want[key]), key
        for var in want[key]:
            np.testing.assert_array_equal(got[key][var], want[key][var],
                                          err_msg=f"{key} {var}")


def _both(module_pair, fn):
    return [fn(m) for m in module_pair]


EVENTS_PI = (torch_events_pi, jax_events_pi)


@pytest.mark.parametrize("fraction", [None, 0.3])
def test_events_pi_load_matches_jax(fraction):
    """The repo's file (the legacy nested layout with the old 'oppo' flux
    names), variable mapping with stacked columns, and the subsample
    chooser at index 1."""
    got, want = _both(EVENTS_PI, lambda m: m.EventsPi(
        name="ev", fraction_events_to_keep=fraction,
        events_subsample_index=0 if fraction is None else 1))
    for evts in (got, want):
        evts.load_events_file(EVENTS, variable_mapping=DATA_DICT, seed=7)
    assert len(got) == 12
    assert_events_equal(got, want)
    if fraction is not None:
        assert got["numu_cc"]["pid"].shape == (30,)


def test_events_pi_cuts_match_jax():
    evts = []
    for m, b in ((torch_events_pi, torch_binning),
                 (jax_events_pi, jax_binning)):
        e = m.EventsPi(name="ev")
        e.load_events_file(EVENTS)
        binning = b.MultiDimBinning([
            b.OneDimBinning("true_energy", num_bins=4, is_log=True,
                            domain=[2, 50]),
            b.OneDimBinning("true_coszen", num_bins=2, is_lin=True,
                            domain=[-1, 0.5]),
        ])
        cut = e.apply_cut("(pid >= -1) & (true_energy > 3)")
        evts.append((cut, cut.keep_inbounds(binning)))
        assert cut.apply_cut("(pid >= -1) & (true_energy > 3)") is cut
    for got, want in zip(*evts):
        assert got.metadata["cuts"] == want.metadata["cuts"]
        assert_events_equal(got, want)
    assert 0 < len(evts[0][1]["numu_cc"]["pid"]) < 100


def test_flavour_split_and_oppo_fix_match_jax():
    """Events given by PDG code and interaction (the flat layout) split
    into the 12 categories, and the legacy 'oppo' flux keys renamed."""
    rng = np.random.RandomState(3)
    n = 400
    flat = {
        "pdg_code": rng.choice([12, -12, 14, -14, 16, -16], n),
        "interaction": rng.choice([1, 2], n),
        "true_energy": rng.uniform(1, 80, n),
    }
    for k in ("neutrino_nue_flux", "neutrino_numu_flux",
              "neutrino_oppo_nue_flux", "neutrino_oppo_numu_flux"):
        flat[k] = rng.uniform(size=n)
    got, want = _both(EVENTS_PI, lambda m: m.split_nu_events_by_flavor_and_interaction(
        {"all": {k: v.copy() for k, v in flat.items()}}))
    for out, m in ((got, torch_events_pi), (want, jax_events_pi)):
        m.fix_oppo_flux(out)
    assert_events_equal(got, want)
    assert sorted(got) == sorted(torch_events_pi.OUTPUT_NUFLAVINT_KEYS)
    assert "nominal_nuebar_flux" in got["nuebar_cc"]


def _legacy_events(m):
    rng = np.random.RandomState(5)
    val = {fi: {"true_energy": rng.uniform(1, 100, 150 + 10 * i),
                "true_coszen": rng.uniform(-1, 1, 150 + 10 * i),
                "weights": rng.rand(150 + 10 * i)}
           for i, fi in enumerate(["nue_cc", "numu_cc", "nutau_cc",
                                   "nuebar_cc", "numubar_cc"])}
    return m.Events(val)


def test_legacy_events_and_data_match_jax():
    """``Events``: cut, in-bounds cut, histogram; ``Data``: groups with a
    muon side-band, cuts, the MapSet of ``histogram_set``."""
    out = []
    for m, b in ((torch_events, torch_binning), (jax_events, jax_binning)):
        ebins = b.OneDimBinning("true_energy", num_bins=10, is_log=True,
                                domain=(5, 50), units="GeV")
        ev = _legacy_events(m)
        cut = ev.applyCut("(true_energy >= 10) & (true_coszen < 0.5)")
        inb = cut.keepInbounds(ebins)
        h = inb.histogram("numu_cc", ebins, weights_col="weights",
                          errors=True)
        rng = np.random.RandomState(9)
        data = m.Data({
            "nue_cc+nuebar_cc": {"true_energy": rng.uniform(1, 60, 80),
                                 "w": rng.rand(80)},
            "muons": {"true_energy": rng.uniform(1, 60, 30),
                      "w": rng.rand(30)},
        })
        data = data.applyCut("true_energy > 6").keepInbounds(ebins)
        hs = data.histogram_set(ebins, "w", "w", None, "set", errors=True)
        out.append((inb, h, hs, data.digitize("muons", ebins)))
    (ev, h, hs, dig), (jev, jh, jhs, jdig) = out
    assert ev.metadata["cuts"] == jev.metadata["cuts"]
    for fi in jev.flavints_present:
        for var in jev[fi]:
            np.testing.assert_array_equal(ev[fi][var], jev[fi][var])
    for got, want in [(h, jh)] + list(zip(hs, jhs)):
        assert got.name == want.name
        np.testing.assert_allclose(got.hist, np.asarray(want.hist),
                                   rtol=HIST_RTOL)
        np.testing.assert_allclose(got.error_hist,
                                   np.asarray(want.error_hist),
                                   rtol=HIST_RTOL)
    np.testing.assert_array_equal(dig, jdig)


def test_make_toy_events_equal_for_one_seed():
    got, want = make_toy_events(num_events=40, seed=11), jax_toy(
        num_events=40, seed=11)
    assert list(got) == list(want)
    for flav in want:
        for it in want[flav]:
            assert list(got[flav][it]) == list(want[flav][it])
            for k in want[flav][it]:
                np.testing.assert_array_equal(got[flav][it][k],
                                              want[flav][it][k])


def test_simple_data_loader_through_both_harnesses():
    """The service's ``init_test`` on each harness's empty source set:
    the same containers, set up and applied; the port's harness reports
    it ok (it has no map mode)."""
    assert TSM.run_service("data", "simple_data_loader", "events",
                           device="cpu") == "ok"
    assert TSM.run_service("data", "simple_data_loader", "map",
                           device="cpu") == "n/a"
    assert JSM.run_service("data", "simple_data_loader") == "ok"
    svc = TSM.prepare_service("data", "simple_data_loader", device="cpu")
    svc.setup()
    svc.run()
    jsvc = jax_loader.init_test()
    jsvc.data = JaxContainerSet("test", [])
    jsvc.data["output_binning"] = JSM.TEST_BINNING
    jsvc.setup()
    jsvc.run()
    assert svc.data.names == jsvc.data.names
    for c in jsvc.data:
        got = svc.data[c.name]
        assert got["nubar"] == c["nubar"] and got["flav"] == c["flav"]
        for key in c.keys:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(c[key]), err_msg=key)


def test_simple_data_loader_takes_a_mapping():
    """``events_file`` as a mapping (``make_toy_events``' output)."""
    toy = make_toy_events(num_events=30, seed=2)
    kwargs = dict(events_file=toy, mc_cuts="(pid >= -3)",
                  data_dict={"true_energy": "true_energy", "pid": "pid"},
                  output_names=["numu_cc", "nutaubar_nc"])
    svc = torch_loader.simple_data_loader(**kwargs)
    svc.data = ContainerSet("t", device="cpu")
    svc.setup()
    jsvc = jax_loader.simple_data_loader(**kwargs)
    jsvc.data = JaxContainerSet("t", [])
    jsvc.setup()
    for name in ("numu_cc", "nutaubar_nc"):
        np.testing.assert_array_equal(
            svc.data[name]["true_energy"].numpy(),
            np.asarray(jsvc.data[name]["true_energy"]))
    assert svc.data["numu_cc"].size == 30


def _assert_maps(got, want, tol=MAP_TOL):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_maps(g, w, tol)
        return
    assert [m.name for m in got] == [m.name for m in want]
    for m in want:
        ref = np.asarray(m.hist)
        scale = max(np.abs(ref).max(), 1e-300)
        np.testing.assert_allclose(got[m.name].hist, ref, rtol=tol,
                                   atol=tol * scale, err_msg=m.name)
        if m.error_hist is not None:
            ref = np.asarray(m.error_hist)
            np.testing.assert_allclose(
                got[m.name].error_hist, ref, rtol=tol,
                atol=tol * max(np.abs(ref).max(), 1e-300), err_msg=m.name)


@pytest.mark.parametrize("cfg", ["example", "fast_example", "osc_example",
                                 "toy_flux_fit"])
def test_config_maps_match_jax(cfg):
    path = f"settings/pipeline/{cfg}.cfg"
    got = TorchPipeline(path, device="cpu").get_outputs()
    want = JaxPipeline(path).get_outputs()
    _assert_maps(got, want)


VARBIN = "settings/pipeline/varbin_example.cfg"


def test_varbin_example_matches_jax():
    """varbin_example's per-selection maps against the JAX package's;
    DistributionMaker(return_sum=True) and its Pipeline's return_sum: one
    summed MapSet per selection, against the sums of the JAX maps; and
    selections given as cut strings (``Container.get_keep_mask``) equal to
    the same split given as a PID binning (``reco_var_binning``: [-3, 0)
    and [0, 1000]). One test, not several around a module fixture: the
    JAX package's eager per-selection histograms take ~15 s, and each xdist
    worker would build a fixture again."""
    want_maps = JaxPipeline(VARBIN).get_outputs()
    dm = DistributionMaker([VARBIN], device="cpu")
    pipeline = dm.pipelines[0]
    by_bins = pipeline.get_outputs()
    _assert_maps(by_bins, want_maps)
    assert len(by_bins) == 2 and by_bins[1]["numu_cc"].hist.shape == (10, 20)
    want = [ms.sum() for ms in want_maps]
    for got in (dm.get_outputs(return_sum=True),
                pipeline.get_outputs(return_sum=True)):
        assert len(got) == 2
        for g, w in zip(got, want):
            assert len(g) == 1
            ref = np.asarray(w.hist)
            np.testing.assert_allclose(g.maps[0].hist, ref, rtol=MAP_TOL,
                                       atol=MAP_TOL * ref.max())
    binning = pipeline.output_binning
    cuts = type(binning)(binning.binnings,
                         ["(pid >= -3) & (pid < 0)",
                          "(pid >= 0) & (pid <= 1000)"])
    by_cuts = pipeline.get_outputs(output_binning=cuts)
    for g, w in zip(by_cuts, by_bins):
        for m in w:
            np.testing.assert_array_equal(g[m.name].hist, m.hist)
            np.testing.assert_array_equal(g[m.name].error_hist, m.error_hist)
