"""
The port's remaining services (``aeff.param``, ``aeff.weight``,
``aeff.weight_hnl``, ``reco.simple_param``, ``reco.resolutions``,
``utils.adhoc_sys``, ``utils.bootstrap``, ``utils.fix_error``,
``utils.kfold``, ``utils.set_variance``, ``data.grid``,
``data.sqlite_loader``, ``cont_sys.snowstorm_hist``), hist's options
(``apply_unc_weights``, ``unweighted``, the binned calc mode) and
csv_loader's (``neutrinos=False``, ``dis_idx``, ``scale_aeff``) against the
JAX package's, in fp64 on the CPU (conftest): each through both packages'
service-matrix harnesses on the same synthetic containers (these services
have no map mode, in either package), with the parameters moved off their
nominal values; each parameter gradient against the JAX package's
``jax.grad``; the random streams (the reco smearing, the bootstrap counts,
the k-fold masks) bit for bit; the port's numpy k-fold split against
scikit-learn's; and the port's package data.

Tolerances: outputs 1e-10 relative (the same arithmetic, in another
order); gradients 1e-9 relative of the largest entry; the random streams
exactly.
"""

import glob
import importlib
import os
import sys
import tomllib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.core import binning as jax_binning
from pisa_tpu.core.container import ContainerSet as JaxContainerSet
from pisa_tpu.testing import service_matrix as JSM
from pisa_tpu_torch import ureg as torch_ureg
from pisa_tpu_torch.core import binning as torch_binning
from pisa_tpu_torch.core.container import ContainerSet as TorchContainerSet
from pisa_tpu_torch.stages.utils.kfold import kfold_test_indices
from pisa_tpu_torch.testing import service_matrix as TSM

OUT_RTOL = 1e-10
GRAD_RTOL = 1e-9
SEED = 42
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: case -> (stage package, service module, the service's options or None
#: for its init_test, the keys compared, the parameter values it runs at)
SERVICES = {
    "aeff.param": ("aeff", "param", None, ("weights",),
                   {"aeff_scale": 1.3, "livetime": 12.0}),
    "aeff.weight": ("aeff", "weight", None, ("weights",),
                    {"weight_scale": 0.8, "livetime": 2.0}),
    "aeff.weight_hnl": ("aeff", "weight_hnl", None, ("weights",),
                        {"U_tau4_sq": 2e-2}),
    "reco.simple_param": ("reco", "simple_param", None,
                          ("reco_energy", "reco_coszen", "pid"), {}),
    "reco.resolutions": ("reco", "resolutions", None,
                         ("reco_energy", "reco_coszen", "pid"), {}),
    "utils.adhoc_sys": ("utils", "adhoc_sys", None, ("weights",), {}),
    "utils.bootstrap": ("utils", "bootstrap", {"seed": 11},
                        ("weights", "bootstrap_weights"), {}),
    "utils.fix_error": ("utils", "fix_error", None, ("errors",), {}),
    "utils.kfold": ("utils", "kfold",
                    {"n_splits": 3, "select_split": 1, "seed": 5,
                     "shuffle": True},
                    ("weights", "fold_weight"), {}),
    "data.grid": ("data", "grid", None,
                  ("true_energy", "true_coszen", "weights"), {}),
    "data.sqlite_loader": ("data", "sqlite_loader", None,
                           ("true_energy", "true_coszen", "reco_energy",
                            "reco_coszen", "pid", "weighted_aeff",
                            "weights"), {}),
    "cont_sys.snowstorm_hist": ("cont_sys", "snowstorm_hist", None,
                                ("weights", "syst_scale"),
                                {"dom_eff": 1.02}),
    "hist.apply_unc_weights": ("utils", "hist",
                               {"apply_unc_weights": True,
                                "error_method": "sumw2"},
                               ("weights", "errors", "bin_unc2"), {}),
    "hist.unweighted": ("utils", "hist",
                        {"unweighted": True, "error_method": "sumw2"},
                        ("weights", "errors", "bin_unc2"), {}),
    "hist.binned_calc": ("utils", "hist",
                         {"calc_mode": "reco", "apply_unc_weights": True,
                          "error_method": "sumw2"},
                         ("weights", "errors", "bin_unc2"), {}),
}

#: case -> {key: f}: the harness's synthetic values x of a key replaced by
#: f(x), where they would make the service's output trivial: HNL decay widths
#: of ~1e-16 GeV (the harness's ~0.5 GeV give exp(-1e13) = 0), and DOM
#: efficiencies on both sides of the central 1.0 (the harness's lie below)
OVERRIDES = {
    "aeff.weight_hnl": {"hnl_decay_width": lambda x: x * 1e-16},
    "cont_sys.snowstorm_hist": {"dom_eff": lambda x: 0.7 + 0.6 * x},
}

#: the services whose outputs come from random streams: held bit for bit
EXACT = {"reco.simple_param", "utils.bootstrap", "utils.kfold"}

#: the 13 services this slice ports (the hist options are options)
NEW_SERVICES = [
    ("aeff", "param"), ("aeff", "weight"), ("aeff", "weight_hnl"),
    ("reco", "simple_param"), ("reco", "resolutions"),
    ("utils", "adhoc_sys"), ("utils", "bootstrap"), ("utils", "fix_error"),
    ("utils", "kfold"), ("utils", "set_variance"), ("data", "grid"),
    ("data", "sqlite_loader"), ("cont_sys", "snowstorm_hist"),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _host(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) \
        else x.detach().numpy()


def _reco_binning(binning, ureg):
    """A binning of the reco variables, disjoint from the harness's (true)
    TEST_BINNING: the binned calc mode's calc binning."""
    return binning.MultiDimBinning([
        binning.OneDimBinning("reco_energy", num_bins=4, is_log=True,
                              domain=[6, 80] * ureg.GeV),
        binning.OneDimBinning("reco_coszen", num_bins=3, is_lin=True,
                              domain=[-1, 1]),
    ], name="reco_test")


def _service(package, case):
    """The service of `case` (its init_test, or made with the case's
    options, in events calc mode unless they say "reco": the binned one) at
    its test values, with the harness's synthetic data (the same for both
    packages, with the case's OVERRIDES), set up."""
    stage, name, options, _, values = SERVICES[case]
    if package == "pisa_tpu":
        harness, ureg, binning, kw = JSM, jax_ureg, jax_binning, {}
    else:
        harness, ureg, binning, kw = (TSM, torch_ureg, torch_binning,
                                      {"device": "cpu"})
    module = importlib.import_module(f"{package}.stages.{stage}.{name}")
    if options is None:
        service = module.init_test()
    else:
        options = dict(options)
        if options.get("calc_mode") == "reco":
            options["calc_mode"] = _reco_binning(binning, ureg)
            options["apply_mode"] = harness.TEST_BINNING
        else:
            options["calc_mode"] = "events"
        service = getattr(module, name)(**options)
    for pname, value in values.items():
        p = service.params[pname]
        p.value = value * p.units
    rng = np.random.RandomState(SEED)
    if name in harness.SOURCE_SERVICES:
        data = (JaxContainerSet("test", []) if package == "pisa_tpu"
                else TorchContainerSet("test", device="cpu"))
        data["output_binning"] = harness.TEST_BINNING
    else:
        data = harness.make_events_data(service, rng, **kw)
    service.data = data
    for key, f in OVERRIDES.get(case, {}).items():
        for c in service.data:
            c[key] = f(_host(c[key]))
    service.setup()
    return service


def _outputs(package, case):
    service = _service(package, case)
    service.run()
    return {(c.name, k): _host(c[k]) for c in service.data
            for k in SERVICES[case][3]}


@pytest.mark.parametrize("case", list(SERVICES))
def test_service_matches_jax(case):
    want = _outputs("pisa_tpu", case)
    got = _outputs("pisa_tpu_torch", case)
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        assert got[key].shape == ref.shape, key
        assert np.all(np.isfinite(got[key])), key
        if case in EXACT:
            np.testing.assert_array_equal(got[key], ref, err_msg=str(key))
        else:
            np.testing.assert_allclose(got[key], ref, rtol=OUT_RTOL, atol=0,
                                       err_msg=str(key))
    if SERVICES[case][4] or case in EXACT or case.startswith("hist"):
        # the service changes something
        assert any(not np.allclose(v, 1.0) for v in got.values())


def test_new_services_report_ok_in_the_matrix():
    """The port's service matrix reports each new service ok in events
    mode and n/a in map mode, as the JAX package's has them."""
    for stage, name in NEW_SERVICES:
        assert (stage, name) not in JSM.MAP_MODE_SERVICES
        assert TSM.run_service(stage, name, "events", device="cpu") == "ok"
        assert TSM.run_service(stage, name, "map", device="cpu") == "n/a"
    assert TSM.run_service("utils", "hist", "events", device="cpu") == "ok"


def _loss_weights(service, keys):
    rng = np.random.RandomState(7)
    return {(c.name, k): rng.uniform(0.5, 1.5, tuple(c[k].shape))
            for c in service.data for k in keys}


def _jax_grad(case, names):
    service = _service("pisa_tpu", case)
    service._trace_mode = True
    keys = SERVICES[case][3]
    rw = None

    def loss(v):
        nonlocal rw
        for pname, x in zip(names, v):
            p = service.params[pname]
            p._value = jax_ureg.Quantity(x, p.units)
        service.run()
        if rw is None:
            rw = _loss_weights(service, keys)
        return sum(jnp.sum(c[k] * rw[(c.name, k)]) for c in service.data
                   for k in keys)

    v0 = jnp.asarray([SERVICES[case][4][n] for n in names])
    return np.asarray(jax.grad(loss)(v0))


def _torch_grad(case, names):
    service = _service("pisa_tpu_torch", case)
    service._template_mode = True
    keys = SERVICES[case][3]
    v = torch.tensor([SERVICES[case][4][n] for n in names],
                     dtype=torch.float64, requires_grad=True)
    for pname, x in zip(names, v.unbind()):
        p = service.params[pname]
        p._value = torch_ureg.Quantity(x, p.units)
    service.run()
    rw = _loss_weights(service, keys)
    loss = sum((c[k] * torch.as_tensor(rw[(c.name, k)])).sum()
               for c in service.data for k in keys)
    (g,) = torch.autograd.grad(loss, v)
    return g.numpy()


@pytest.mark.parametrize("case", [c for c in SERVICES if SERVICES[c][4]])
def test_parameter_gradients_match_jax(case):
    """d(sum of the outputs x fixed random weights)/d(each parameter) at
    the test values: the port's autograd against ``jax.grad``."""
    names = sorted(SERVICES[case][4])
    want = _jax_grad(case, names)
    got = _torch_grad(case, names)
    assert np.all(np.isfinite(want)) and np.all(want != 0)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_RTOL * np.abs(want).max())


def test_hist_adds_astro_weights_as_jax_does():
    """With flux.astrophysical's ``astro_weights`` in the containers, hist
    histograms weights + astro_weights."""
    case = "hist.apply_unc_weights"
    outputs = {}
    for package in ("pisa_tpu", "pisa_tpu_torch"):
        service = _service(package, case)
        rng = np.random.RandomState(9)
        for c in service.data:
            c.representation = "events"
            c["astro_weights"] = rng.uniform(0.5, 2.0, c.size)
        service.run()
        outputs[package] = {(c.name, k): _host(c[k]) for c in service.data
                            for k in SERVICES[case][3]}
    plain = _outputs("pisa_tpu_torch", case)
    for key, ref in outputs["pisa_tpu"].items():
        np.testing.assert_allclose(outputs["pisa_tpu_torch"][key], ref,
                                   rtol=OUT_RTOL, atol=0, err_msg=str(key))
        assert not np.allclose(ref, plain[key])


@pytest.mark.parametrize("shuffle,seed", [(False, None), (True, 0),
                                          (True, 123)])
@pytest.mark.parametrize("n,k", [(40, 2), (41, 3), (100, 7), (5, 5)])
def test_kfold_split_matches_sklearn(n, k, shuffle, seed):
    """Every fold of the port's numpy split is scikit-learn's KFold's."""
    from sklearn.model_selection import KFold

    want = [test for _, test in KFold(n_splits=k, shuffle=shuffle,
                                      random_state=seed).split(np.zeros(n))]
    for i in range(k):
        np.testing.assert_array_equal(
            kfold_test_indices(n, k, i, shuffle=shuffle, seed=seed), want[i])


def test_kfold_needs_no_sklearn_and_saves_its_mask(monkeypatch):
    """The port's kfold runs with scikit-learn made unimportable; its
    renormalized weights and kfold_mask (read by
    likelihood.generalized_llh_params) are the JAX stage's."""
    from pisa_tpu.stages.utils.kfold import kfold as jax_kfold

    from pisa_tpu_torch.stages.utils.kfold import kfold as torch_kfold

    options = dict(n_splits=3, select_split=1, seed=5, shuffle=True,
                   renormalize=True, save_mask=True, calc_mode="events")
    results = {}
    for package, cls in (("pisa_tpu", jax_kfold),
                         ("pisa_tpu_torch", torch_kfold)):
        if package == "pisa_tpu_torch":
            monkeypatch.setitem(sys.modules, "sklearn", None)
            monkeypatch.setitem(sys.modules, "sklearn.model_selection", None)
        service = cls(**options)
        harness, kw = ((JSM, {}) if package == "pisa_tpu"
                       else (TSM, {"device": "cpu"}))
        service.data = harness.make_events_data(
            service, np.random.RandomState(SEED), **kw)
        service.setup()
        service.run()
        results[package] = {(c.name, k): _host(c[k]) for c in service.data
                            for k in ("weights", "kfold_mask")}
    for key, ref in results["pisa_tpu"].items():
        np.testing.assert_array_equal(results["pisa_tpu_torch"][key], ref)
    mask = results["pisa_tpu_torch"][("nutau_cc", "kfold_mask")]
    assert mask.dtype == np.bool_ and 0 < mask.sum() < mask.size


def test_set_variance_computes_where_the_jax_stage_does_not():
    """The JAX set_variance never runs its compute (``Stage.compute``
    returns at once for a stage with neither params nor expected container
    keys), so its errors are the square root of the uninitialized array
    its set-up allocates. The port's compute runs; its errors are the JAX
    stage's arithmetic (its compute and apply called by hand): the square
    root of weights x variance_scale, times expected / actual MC events
    with divide_total_mc, floored."""
    from pisa_tpu.stages.utils import set_variance as jax_sv

    from pisa_tpu_torch.stages.utils import set_variance as torch_sv

    calls = []
    service = jax_sv.init_test()
    compute = service.compute_function
    service.compute_function = lambda: calls.append(1) or compute()
    service.data = JSM.make_events_data(service, np.random.RandomState(SEED))
    service.setup()
    service.run()
    assert calls == []

    for options in ({}, {"divide_total_mc": True, "variance_floor": 9.5,
                         "variance_scale": 1.5}):
        outputs = {}
        for package, module in (("pisa_tpu", jax_sv),
                                ("pisa_tpu_torch", torch_sv)):
            harness, kw = ((JSM, {}) if package == "pisa_tpu"
                           else (TSM, {"device": "cpu"}))
            binning = module.init_test().calc_mode
            service = module.set_variance(expected_total_mc=100,
                                          calc_mode=binning,
                                          apply_mode=binning, **options)
            service.data = harness.make_events_data(
                service, np.random.RandomState(SEED), **kw)
            service.setup()
            if package == "pisa_tpu":
                service.data.representation = binning
                service.compute_function()
                service.apply_function()
            else:
                service.run()
            outputs[package] = {c.name: _host(c["errors"])
                                for c in service.data}
        for name, ref in outputs["pisa_tpu"].items():
            assert np.all(ref > 0)
            np.testing.assert_allclose(outputs["pisa_tpu_torch"][name], ref,
                                       rtol=OUT_RTOL, atol=0)


def _csv_loader(package, path, **options):
    module = importlib.import_module(f"{package}.stages.data.csv_loader")
    data_dict = {"true_energy": "true_energy", "true_coszen": "true_coszen",
                 "weighted_aeff": "weight", "interaction": "interaction"}
    service = module.csv_loader(events_file=path, data_dict=data_dict,
                                calc_mode="events", apply_mode="events",
                                **options)
    service.data = (JaxContainerSet("test", []) if package == "pisa_tpu"
                    else TorchContainerSet("test", device="cpu"))
    service.setup()
    service.run()
    return service


@pytest.mark.parametrize("options", [
    {"neutrinos": False, "output_names": ["muons"]},
    {"dis_idx": 1, "scale_aeff": True,
     "output_names": ["nue_cc", "numu_cc", "numubar_nc"]},
])
def test_csv_loader_options_match_jax(tmp_path, options):
    """neutrinos=False (every event in each container, no flavour aux
    data), dis_idx (the 'dis' key from the 'interaction' column) and
    scale_aeff (weighted_aeff x 1e-4) on a seeded CSV."""
    rng = np.random.RandomState(3)
    n = 60
    columns = {
        "pdg": rng.choice([12, -12, 14, -14, 16, -16], n),
        "type": rng.choice([0, 1, 2], n),
        "true_energy": 10 ** rng.uniform(0, 2, n),
        "true_coszen": rng.uniform(-1, 1, n),
        "weight": rng.uniform(1, 5, n),
        "interaction": rng.choice([0, 1, 2], n),
    }
    path = os.path.join(tmp_path, "events.csv")
    with open(path, "w") as f:
        f.write(",".join(columns) + "\n")
        for row in zip(*columns.values()):
            f.write(",".join(repr(x.item()) for x in row) + "\n")
    want = _csv_loader("pisa_tpu", path, **options)
    got = _csv_loader("pisa_tpu_torch", path, **options)
    assert got.data.names == want.data.names
    for cw in want.data:
        cg = got.data[cw.name]
        assert sorted(cg.keys) == sorted(cw.keys)
        for key in cw.keys:
            np.testing.assert_allclose(_host(cg[key]), np.asarray(cw[key]),
                                       rtol=OUT_RTOL, atol=0, err_msg=key)
        if options.get("neutrinos", True):
            assert cg["nubar"] == cw["nubar"] and cg["flav"] == cw["flav"]
            assert "dis" in cg.keys
        else:
            assert cg.size == n and "nubar" not in cg


def test_csrc_files_are_package_data():
    """Every file under pisa_tpu_torch/csrc/ matches one of the port's
    package-data globs in pyproject.toml, so an installed (not editable)
    port carries every kernel and host source it builds at first use."""
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "pisa_tpu_torch"]
    package = os.path.join(ROOT, "pisa_tpu_torch")
    shipped = {os.path.normpath(p) for g in globs
               for p in glob.glob(os.path.join(package, g))}
    sources = [os.path.normpath(p) for p in
               glob.glob(os.path.join(package, "csrc", "*"))
               if os.path.isfile(p)]
    assert sources
    assert [p for p in sources if p not in shipped] == []
