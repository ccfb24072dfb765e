"""
The last of the JAX package's public surface in the port, against the JAX
package, in fp64 on the CPU (conftest): the 3-D (azimuth) Honda flux tables,
``OscParams`` and ``pmns_matrix_complex``, the ``Container`` helpers
(``array_to_binned``, ``binned_to_array``, ``resample``, ``keep``, ...) and
the rest of the container, stage and stacking API, ``native.available``,
``CACHE_DIR``, the 11 services' ``init_test``s (their parameters and
options, and every service's status in both packages' service matrices),
and ``flux.airs`` and ``data.licloader_weighter`` under stub
``photospline`` and ``LeptonWeighter`` modules (the same stubs, inputs and
file for both packages), and their error messages without them.

Tolerances: the 3-D flux 1e-12 relative (the same numpy and scipy code);
the PMNS matrices 1e-15; the container helpers bit-equal; airs and
licloader_weighter's outputs, and airs's gradient in airs_scale, 1e-12
relative.
"""

import importlib
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

from pisa_tpu import CACHE_DIR as JAX_CACHE_DIR
from pisa_tpu import ureg as jax_ureg
from pisa_tpu.core import binning as jax_binning
from pisa_tpu.core.container import Container as JaxContainer
from pisa_tpu.core.container import ContainerSet as JaxContainerSet
from pisa_tpu.core.container import VirtualContainer as JaxVirtualContainer
from pisa_tpu.core.stacking import StackedContainer as JaxStacked
from pisa_tpu.ops.osc import pmns as jax_pmns
from pisa_tpu.testing import service_matrix as JSM
from pisa_tpu.utils import flux_weights as jax_flux
from pisa_tpu.utils.llh_defs import native as jax_native
import pisa_tpu_torch
from pisa_tpu_torch import ureg as torch_ureg
from pisa_tpu_torch.core import binning as torch_binning
from pisa_tpu_torch.core.container import Container as TorchContainer
from pisa_tpu_torch.core.container import ContainerSet as TorchContainerSet
from pisa_tpu_torch.core.container import Shard
from pisa_tpu_torch.core.container import VirtualContainer as TorchVirtual
from pisa_tpu_torch.core.stacking import StackedContainer as TorchStacked
from pisa_tpu_torch.ops.osc import pmns as torch_pmns
from pisa_tpu_torch.testing import service_matrix as TSM
from pisa_tpu_torch.utils import flux_weights as torch_flux
from pisa_tpu_torch.utils.hdf import to_hdf
from pisa_tpu_torch.utils.llh_defs import native as torch_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLUX_RTOL = 1e-12
PMNS_ATOL = 1e-15
OUT_RTOL = 1e-12
SEED = 42
HONDA_3D = "flux/honda-2015-spl-solmin.d"
#: any file both packages' find_resource locates; the stubs do not read it
ANY_FILE = "flux/honda-2015-spl-solmin-aa.d"

#: the services whose init_test the port lacked, by stage
INIT_TESTS = [
    ("aeff", "aeff"), ("data", "csv_data_hist"), ("data", "csv_icc_hist"),
    ("data", "csv_loader"), ("data", "toy_event_generator"),
    ("flux", "barr_simple"), ("flux", "daemon_flux"), ("flux", "honda_ip"),
    ("likelihood", "generalized_llh_params"), ("osc", "prob3"),
    ("utils", "add_indices"),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _host(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# -- the 3-D flux tables -------------------------------------------------------
@pytest.fixture(scope="module")
def honda_3d():
    """{enpow: (JAX table, port table)}."""
    return {enpow: (jax_flux.load_3d_table(HONDA_3D, enpow=enpow),
                    torch_flux.load_3d_table(HONDA_3D, enpow=enpow))
            for enpow in (1, 2)}


@pytest.mark.parametrize("enpow", [1, 2])
@pytest.mark.parametrize("az_linear", [True, False])
def test_3d_flux_matches_jax(honda_3d, enpow, az_linear):
    """Every primary on 500 seeded (E, cz, az) points, azimuths across the
    full circle (both sides of the 15-degree wrap)."""
    rng = np.random.RandomState(SEED + enpow)
    n = 500
    energy = 10 ** rng.uniform(-0.5, 3.5, n)
    coszen = rng.uniform(-1, 1, n)
    azimuth = rng.uniform(0, 2 * np.pi, n)
    jax_table, torch_table = honda_3d[enpow]
    assert sorted(torch_table.keys()) == sorted(jax_table.keys())
    np.testing.assert_array_equal(torch_table.cz_spline_points,
                                  jax_table.cz_spline_points)
    np.testing.assert_array_equal(torch_table.az_points_deg,
                                  jax_table.az_points_deg)
    for primary in jax_table.keys():
        want = jax_flux.calculate_3d_flux_weights(
            energy, coszen, azimuth, jax_table[primary], enpow=enpow,
            az_linear=az_linear)
        got = torch_flux.calculate_3d_flux_weights(
            energy, coszen, azimuth, torch_table[primary], enpow=enpow,
            az_linear=az_linear)
        assert got.shape == (n,) and np.all(np.isfinite(got))
        assert np.all(want > 0)
        np.testing.assert_allclose(got, want, rtol=FLUX_RTOL, atol=0,
                                   err_msg=primary)


def _error(fn, *args, **kwargs):
    with pytest.raises(Exception) as info:
        fn(*args, **kwargs)
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("call", [
    ("load_3d_table", ("flux/honda-2015-spl-solmin-aa.d",), {}),
    ("load_3d_table", ("flux/bartol-2004.d",), {}),
    ("load_3d_honda_table", (HONDA_3D,), {"enpow": 1.0}),
    ("calculate_3d_flux_weights", (np.ones(2), np.ones(3), np.ones(2),
                                   None), {}),
    ("calculate_3d_flux_weights", (np.ones(2), np.full(2, 1.5),
                                   np.ones(2), None), {}),
    ("calculate_3d_flux_weights", (np.ones(2), np.ones(2), -np.ones(2),
                                   None), {}),
])
def test_3d_flux_raises_as_jax(call):
    name, args, kwargs = call
    assert _error(getattr(torch_flux, name), *args, **kwargs) == \
        _error(getattr(jax_flux, name), *args, **kwargs)


# -- OscParams and pmns_matrix_complex -----------------------------------------
def _osc_points():
    rng = np.random.RandomState(SEED)
    points = [(0.55, 0.15, 0.75, 0.0, 7.5e-5, 2.5e-3),
              (0.0, 0.0, 0.0, 0.0, 0.0, 0.0)]
    for _ in range(3):
        points.append((*rng.uniform(0, 1, 3), rng.uniform(0, 2 * np.pi),
                       rng.uniform(0, 1e-4), rng.uniform(-3e-3, 3e-3)))
    return points


@pytest.mark.parametrize("point", _osc_points())
@pytest.mark.parametrize("reparam", [False, True])
def test_pmns_matrix_complex_matches_jax(point, reparam):
    sins, dcp = point[:3], point[3]
    want = jax_pmns.pmns_matrix_complex(*sins, dcp, reparam=reparam)
    got = torch_pmns.pmns_matrix_complex(*sins, dcp, reparam=reparam)
    assert isinstance(got, np.ndarray) and got.dtype == np.complex128
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=PMNS_ATOL)


@pytest.mark.parametrize("point", _osc_points())
def test_osc_params_match_jax(point):
    """Angles set through theta (and read back as sines), the phase and
    splittings as attributes; every matrix property."""
    s12, s13, s23, dcp, dm21, dm31 = point
    objects = (jax_pmns.OscParams(), torch_pmns.OscParams())
    for o in objects:
        o.theta12, o.theta13 = np.arcsin(s12), np.arcsin(s13)
        o.sin23 = s23
        o.deltacp, o.dm21, o.dm31 = dcp, dm21, dm31
    want, got = objects
    for name in ("sin12", "sin13", "sin23", "theta12", "theta13", "theta23",
                 "deltacp", "dm21", "dm31"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=PMNS_ATOL, err_msg=name)
    for name in ("mix_matrix", "mix_matrix_complex", "mix_matrix_reparam",
                 "mix_matrix_reparam_complex", "dm_matrix"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        assert isinstance(g, np.ndarray) and g.shape == w.shape, name
        assert g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, rtol=0, atol=PMNS_ATOL,
                                   err_msg=name)
    assert got.mix_matrix.shape == (3, 3, 2)
    # the degeneracy break where a splitting is zero
    assert np.count_nonzero(got.dm_matrix) == np.count_nonzero(want.dm_matrix)


# -- the Container helpers -----------------------------------------------------
def _binnings(module, ureg, size):
    return module.MultiDimBinning([
        module.OneDimBinning("true_energy", num_bins=size, is_log=True,
                             domain=[1, 100] * ureg.GeV),
        module.OneDimBinning("true_coszen", num_bins=size - 2, is_lin=True,
                             domain=[-1, 1]),
    ], name=f"grid{size}")


def _inputs():
    rng = np.random.RandomState(SEED)
    n = 300
    events = {
        # some events outside the binnings' energies
        "true_energy": 10 ** rng.uniform(-0.2, 2.2, n),
        "true_coszen": rng.uniform(-1, 1, n),
        "weights": rng.uniform(0.1, 2.0, n),
        "flux": rng.uniform(0.5, 1.5, (n, 2)),
    }
    return events, rng.uniform(0, 1, 12 * 10), rng.uniform(0, 1, n) < 0.6


def _container(package):
    """The same events and grid values in `package`'s container: (container,
    fine 12x10 grid, coarse 5x3 grid)."""
    events, grid_values, _ = _inputs()
    if package == "pisa_tpu":
        c = JaxContainer("nu")
        fine = _binnings(jax_binning, jax_ureg, 12)
        coarse = _binnings(jax_binning, jax_ureg, 5)
    else:
        c = TorchContainer("nu", device="cpu")
        fine = _binnings(torch_binning, torch_ureg, 12)
        coarse = _binnings(torch_binning, torch_ureg, 5)
    for key, value in events.items():
        c[key] = value
    c.set_aux_data("nubar", 1)
    c.representation = fine
    c["prob"] = grid_values
    c.representation = "events"
    return c, fine, coarse


@pytest.fixture(scope="module")
def containers():
    return {p: _container(p) for p in ("pisa_tpu", "pisa_tpu_torch")}


def _helper_calls(c, fine, coarse):
    return {
        "array_to_binned mean": c.array_to_binned("weights", "events", fine),
        "array_to_binned sum": c.array_to_binned("weights", "events", coarse,
                                                 averaged=False),
        "array_to_binned channels": c.array_to_binned("flux", "events",
                                                      fine),
        "binned_to_array": c.binned_to_array("prob", fine, "events"),
        "resample": c.resample("prob", fine, coarse),
        "unroll_binning": c.unroll_binning("true_coszen", fine),
    }


def test_container_helpers_match_jax_bit_for_bit(containers):
    want = _helper_calls(*containers["pisa_tpu"])
    got = _helper_calls(*containers["pisa_tpu_torch"])
    for name, ref in want.items():
        g = _host(got[name])
        assert g.dtype == np.float64, name
        np.testing.assert_array_equal(g, np.asarray(ref), err_msg=name)
    # the helpers store nothing
    c = containers["pisa_tpu_torch"][0]
    assert set(c.validity["weights"].values()) == {True}
    assert len(c.validity["weights"]) == 1


def test_container_keep_matches_jax():
    """The port's keep drops the index caches built on the events, so a
    histogram after the cut is the JAX package's on a container cut before
    any was built (see the next test)."""
    _, _, mask = _inputs()
    results = {}
    for package in ("pisa_tpu", "pisa_tpu_torch"):
        c, fine, _ = _container(package)
        if package == "pisa_tpu_torch":
            c.array_to_binned("weights", "events", fine)
        c.keep(mask if package == "pisa_tpu" else torch.as_tensor(mask))
        results[package] = (
            {k: _host(c[k]) for k in ("true_energy", "true_coszen",
                                      "weights", "flux")},
            _host(c.array_to_binned("weights", "events", fine)),
            c.size)
        with pytest.raises(ValueError, match="binned representation"):
            c.representation = fine
            c.keep(mask)
    (want, want_hist, want_size), (got, got_hist, got_size) = \
        results["pisa_tpu"], results["pisa_tpu_torch"]
    assert got_size == want_size == int(mask.sum())
    for key, ref in want.items():
        np.testing.assert_array_equal(got[key], ref, err_msg=key)
    np.testing.assert_array_equal(got_hist, want_hist)


def test_jax_keep_keeps_stale_indices():
    """Reference fault not copied: the JAX ``Container.keep`` keeps the flat
    bin indices cached before the cut, so a histogram after it fails (the
    port's keep drops them: the previous test)."""
    _, _, mask = _inputs()
    c, fine, _ = _container("pisa_tpu")
    c.array_to_binned("weights", "events", fine)
    c.keep(mask)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        c.array_to_binned("weights", "events", fine)


def test_container_properties_match_jax(containers):
    (jc, jfine, _), (tc, tfine, _) = (containers["pisa_tpu"],
                                      containers["pisa_tpu_torch"])
    assert tc.valid_translation_modes == jc.valid_translation_modes
    assert len(tc.representations) == len(jc.representations) == 2
    assert tc.representation_keys == tuple(
        hash(r) for r in tc.representations)
    assert tc.num_dims == jc.num_dims == 1
    assert sorted(tc.keys_incl_aux_data) == sorted(jc.keys_incl_aux_data)
    for c, fine in ((jc, jfine), (tc, tfine)):
        c.representation = fine
    try:
        assert tc.num_dims == jc.num_dims == 2
        assert sorted(tc.keys_incl_aux_data) == sorted(jc.keys_incl_aux_data)
    finally:
        for c in (jc, tc):
            c.representation = "events"


def test_mark_valid_and_the_virtual_container_match_jax():
    events, _, _ = _inputs()
    states = {}
    for package, make, virtual, cset in (
            ("pisa_tpu", lambda n: JaxContainer(n), JaxVirtualContainer,
             lambda cs: JaxContainerSet("s", cs)),
            ("pisa_tpu_torch", lambda n: TorchContainer(n, device="cpu"),
             TorchVirtual,
             lambda cs: TorchContainerSet("s", device="cpu", containers=cs))):
        a, b = make("a"), make("b")
        for c in (a, b):
            c["true_energy"] = events["true_energy"]
        a["weights"] = events["weights"]
        vc = virtual("ab", [a, b])
        vc.set_aux_data("flav", 1)
        vc["x"] = events["weights"]
        fine = _binnings(jax_binning if package == "pisa_tpu"
                         else torch_binning,
                         jax_ureg if package == "pisa_tpu" else torch_ureg,
                         12)
        vc.representation = fine
        vc.mark_valid("x")
        vc.representation = "events"
        vc.mark_changed("true_energy")
        s = cset([a, b])
        states[package] = (
            vc.shape, [sorted((k, sorted(v.values()))
                              for k, v in c.validity.items())
                       for c in (a, b)],
            [c["flav"] for c in (a, b)],
            s.get_shared_keys(), s.get_shared_keys(rep_indep=False),
            s.is_map)
        s.representation = fine
        states[package] += (s.is_map,)
    assert states["pisa_tpu_torch"] == states["pisa_tpu"]
    assert states["pisa_tpu"][-2:] == (False, True)


def test_stacked_size_and_stage_modes_match_jax():
    fine = {"pisa_tpu": _binnings(jax_binning, jax_ureg, 12),
            "pisa_tpu_torch": _binnings(torch_binning, torch_ureg, 12)}
    sizes = {}
    for package, cls, kw in (("pisa_tpu", JaxStacked, {}),
                             ("pisa_tpu_torch", TorchStacked,
                              {"device": "cpu"})):
        sc = cls("stacked", ["nue_cc", "numu_cc", "nutau_cc"], 17, **kw)
        events_size = sc.size
        sc.representation = fine[package]
        sizes[package] = (events_size, sc.size)
    assert sizes["pisa_tpu_torch"] == sizes["pisa_tpu"] == (51, 120)
    for stage, service in INIT_TESTS:
        modes = []
        for package in ("pisa_tpu", "pisa_tpu_torch"):
            s = importlib.import_module(
                f"{package}.stages.{stage}.{service}").init_test()
            modes.append((s.has_calc_mode, s.has_apply_mode))
        assert modes[0] == modes[1], service


def test_laned_keys_keep_their_lane_axis():
    """A key written with the lane axis (an evaluation of B lanes) goes
    through each helper lane by lane, each lane as the JAX package's
    helper on that lane's values."""
    lanes = 3
    rng = np.random.RandomState(7)
    laned_events = rng.uniform(0.1, 2.0, (lanes, 300))
    laned_grid = rng.uniform(0, 1, (lanes, 120))
    tc, tfine, tcoarse = _container("pisa_tpu_torch")
    tc.lanes = lanes
    tc["w"] = torch.as_tensor(laned_events)
    tc.representation = tfine
    tc["p"] = torch.as_tensor(laned_grid)
    tc.representation = "events"
    tc.lanes = None
    got = {"mean": tc.array_to_binned("w", "events", tfine),
           "sum": tc.array_to_binned("w", "events", tcoarse, averaged=False),
           "lookup": tc.binned_to_array("p", tfine, "events"),
           "resample": tc.resample("p", tfine, tcoarse)}
    for lane in range(lanes):
        jc, jfine, jcoarse = _container("pisa_tpu")
        jc["w"] = laned_events[lane]
        jc.representation = jfine
        jc["p"] = laned_grid[lane]
        jc.representation = "events"
        want = {"mean": jc.array_to_binned("w", "events", jfine),
                "sum": jc.array_to_binned("w", "events", jcoarse,
                                          averaged=False),
                "lookup": jc.binned_to_array("p", jfine, "events"),
                "resample": jc.resample("p", jfine, jcoarse)}
        for name, ref in want.items():
            assert got[name].shape[0] == lanes, name
            np.testing.assert_array_equal(_host(got[name][lane]),
                                          np.asarray(ref), err_msg=name)


class _TwoRanks:
    """A stand-in for a mesh of two ranks holding the same events: the sum
    over the ranks is twice a rank's value."""

    rank, size = 0, 2

    def all_reduce_sum(self, x):
        return 2 * x


def test_sharded_container_helpers():
    """On a sharded container the events-to-binning sum is summed over the
    ranks, and what would need the other ranks' counts raises, as
    ``translate`` does; a mask would change the rank's slice and raises."""
    c, fine, coarse = _container("pisa_tpu_torch")
    plain = c.array_to_binned("weights", "events", coarse, averaged=False)
    lookup = c.binned_to_array("prob", fine, "events")
    c.shard = Shard(mesh=_TwoRanks(), events=(0, 300), n_events=300)
    torch.testing.assert_close(
        c.array_to_binned("weights", "events", coarse, averaged=False),
        2 * plain, rtol=0, atol=0)
    torch.testing.assert_close(c.binned_to_array("prob", fine, "events"),
                               lookup, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="other ranks' counts"):
        c.array_to_binned("weights", "events", coarse)
    c.translation_modes["flux"] = "average"
    c.representation = coarse
    with pytest.raises(NotImplementedError, match="other ranks' counts"):
        c["flux"]
    c.representation = "events"
    with pytest.raises(NotImplementedError, match="slice"):
        c.keep(np.ones(300, dtype=bool))


# -- native.available and CACHE_DIR --------------------------------------------
def test_native_available_matches_jax(tmp_path, monkeypatch):
    assert torch_native.available() == jax_native.available()
    # no compiler and no library built: False, where the route raises
    monkeypatch.setattr(torch_native, "_LIB", None)
    monkeypatch.setattr(torch_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CC", str(tmp_path / "no-such-compiler"))
    assert torch_native.available() is False
    with pytest.raises(RuntimeError, match="no C compiler"):
        torch_native.pg_log_mixture_c(np.ones(1), np.ones((1, 1)),
                                      np.ones((1, 1)))


def test_cache_dir_matches_jax(tmp_path):
    assert pisa_tpu_torch.CACHE_DIR == JAX_CACHE_DIR
    code = "import pisa_tpu_torch; print(pisa_tpu_torch.CACHE_DIR)"
    base = {k: v for k, v in os.environ.items()
            if k not in ("PISA_TPU_CACHE_DIR", "XDG_CACHE_HOME")}
    for env, want in (
            ({"XDG_CACHE_HOME": str(tmp_path)}, str(tmp_path / "pisa_tpu")),
            ({"PISA_TPU_CACHE_DIR": str(tmp_path / "c")}, str(tmp_path / "c"))):
        proc = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            env={**base, **env}, timeout=120, cwd=ROOT,
        )
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip() == want


# -- the services: init_tests, the matrices ------------------------------------
def _quantity(x):
    if hasattr(x, "magnitude"):
        return (np.asarray(x.magnitude).tolist(), str(x.units))
    return x


def _param_record(p):
    return {
        "name": p.name, "value": _quantity(p.value),
        "range": None if p.range is None else [_quantity(r) for r in
                                               p.range],
        "prior": str(p.prior), "is_fixed": p.is_fixed,
        "is_discrete": p.is_discrete, "scales_as_log": p.scales_as_log,
        "nominal_value": _quantity(p.nominal_value),
    }


def _mode(mode):
    if mode is None or isinstance(mode, str):
        return mode
    return [(d.name, np.asarray(d.edge_magnitudes).tolist(), str(d.units))
            for d in mode.dims]


#: service options compared where the JAX service has them
OPTIONS = ("events_file", "data_dict", "output_names", "include_nlo",
           "nsi_type", "reparam_mix_matrix", "neutrino_decay", "lri_type",
           "tomography_type", "expected_params", "error_method")


def _service_record(service):
    record = {"params": [_param_record(p) for p in service.params],
              "calc_mode": _mode(service.calc_mode),
              "apply_mode": _mode(service.apply_mode),
              "expected_container_keys":
                  sorted(service.expected_container_keys)}
    for name in OPTIONS:
        if hasattr(service, name):
            record[name] = getattr(service, name)
    return record


@pytest.mark.parametrize("stage,service", INIT_TESTS)
def test_init_test_builds_what_jax_builds(stage, service):
    want = _service_record(importlib.import_module(
        f"pisa_tpu.stages.{stage}.{service}").init_test())
    got = _service_record(importlib.import_module(
        f"pisa_tpu_torch.stages.{stage}.{service}").init_test())
    assert got == want
    assert want["params"] or service in (
        "csv_data_hist", "csv_loader", "generalized_llh_params",
        "add_indices")


def test_both_matrices_discover_the_same_48_services():
    services = sorted(TSM.discover_services())
    assert services == sorted(JSM.discover_services())
    assert len(services) == 48


@pytest.mark.parametrize("stage,service", sorted(JSM.discover_services()))
def test_matrix_status_matches_jax(stage, service):
    """Each service's status in both modes in the port's matrix (on the
    CPU) is the JAX matrix's; none is a failure or lacks its init_test."""
    for mode in ("events", "map"):
        want = JSM.run_service(stage, service, mode)
        got = TSM.run_service(stage, service, mode, device="cpu")
        assert got == want, (mode, got, want)
        assert not got.startswith("FAIL") and got != "no init_test"


# -- airs and licloader_weighter under stub packages ---------------------------
class _SplineTable:
    """photospline.SplineTable's call of airs, as a smooth function."""

    def __init__(self, path):
        self.path = path

    def evaluate_simple(self, coords):
        log_e, coszen = coords
        return 0.08 * np.sin(2.3 * log_e) * (1.0 + 0.5 * coszen)


class _Weighter:
    """LeptonWeighter.Weighter's call of licloader_weighter."""

    def __init__(self, generators, xs):
        self.scale = 1.0 + 0.1 * len(generators)

    def get_oneweight(self, event):
        return self.scale * (1e-3 * event[0] + event[1] ** 2)


def _stubs(monkeypatch):
    photospline = types.ModuleType("photospline")
    photospline.SplineTable = _SplineTable
    lw = types.ModuleType("LeptonWeighter")
    lw.MakeGeneratorsFromLICFile = lambda path: [("generator", path)]
    lw.CrossSectionFromSpline = lambda *args: "cross sections"
    lw.Weighter = _Weighter
    monkeypatch.setitem(sys.modules, "photospline", photospline)
    monkeypatch.setitem(sys.modules, "LeptonWeighter", lw)


def _airs(package, scale=0.7):
    harness, kw = ((JSM, {}) if package == "pisa_tpu"
                   else (TSM, {"device": "cpu"}))
    mod = importlib.import_module(f"{package}.stages.flux.airs")
    param = importlib.import_module(f"{package}.core.param")
    service = mod.airs(airs_spline=ANY_FILE, params=param.ParamSet(
        [param.Param(name="airs_scale", value=scale)]))
    service.data = harness.make_events_data(
        service, np.random.RandomState(SEED), **kw)
    service.setup()
    return service


def test_airs_matches_jax_under_a_stub(monkeypatch):
    _stubs(monkeypatch)
    results = {}
    for package in ("pisa_tpu", "pisa_tpu_torch"):
        service = _airs(package)
        service.run()
        results[package] = {(c.name, k): _host(c[k]) for c in service.data
                            for k in ("weights", "airs_1s_perturb")}
    for key, ref in results["pisa_tpu"].items():
        got = results["pisa_tpu_torch"][key]
        assert got.dtype == np.float64 and np.all(np.isfinite(got)), key
        np.testing.assert_allclose(got, ref, rtol=OUT_RTOL, atol=0,
                                   err_msg=str(key))
    assert not np.allclose(results["pisa_tpu"][("nutau_cc", "weights")],
                           1.0)


def test_airs_gradient_matches_jax_under_a_stub(monkeypatch):
    """d(sum of the weights x fixed random factors)/d(airs_scale) in
    template mode: the port's autograd against ``jax.grad``."""
    _stubs(monkeypatch)
    service = _airs("pisa_tpu")
    service._trace_mode = True
    rng = np.random.RandomState(9)
    factors = {c.name: rng.uniform(0.5, 1.5, c.size) for c in service.data}

    def loss(x):
        p = service.params["airs_scale"]
        p._value = jax_ureg.Quantity(x, p.units)
        service.run()
        return sum(jax.numpy.sum(c["weights"] * factors[c.name])
                   for c in service.data)

    want = float(jax.grad(loss)(0.7))

    service = _airs("pisa_tpu_torch")
    service._template_mode = True
    x = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    p = service.params["airs_scale"]
    p._value = torch_ureg.Quantity(x, p.units)
    service.run()
    total = sum((c["weights"] * torch.as_tensor(factors[c.name])).sum()
                for c in service.data)
    (got,) = torch.autograd.grad(total, x)
    assert want != 0.0
    np.testing.assert_allclose(float(got), want, rtol=OUT_RTOL, atol=0)


def _lic_events(path):
    rng = np.random.RandomState(SEED)
    n = 400
    to_hdf({
        "PrimaryType": rng.choice([12, -12, 14, -14, 16, -16], n),
        "events": np.stack([rng.uniform(1, 100, n), rng.uniform(0, 1, n)],
                           axis=1),
        "NuEnergy": 10 ** rng.uniform(0, 2, n),
        "NuZenith": rng.uniform(0, np.pi, n),
    }, str(path))


def test_licloader_weighter_matches_jax_under_a_stub(monkeypatch, tmp_path):
    """The same stub and events file (written by the port's HDF5 writer and
    read by each package's reader) give the same containers."""
    _stubs(monkeypatch)
    events = tmp_path / "lic_events.hdf5"
    _lic_events(events)
    names = ["nue_cc", "numu_cc", "nutau_cc", "nuebar_nc", "numubar_cc"]
    results = {}
    for package in ("pisa_tpu", "pisa_tpu_torch"):
        mod = importlib.import_module(
            f"{package}.stages.data.licloader_weighter")
        service = mod.licloader_weighter(
            in_files=str(events), lic_files=[ANY_FILE, ANY_FILE],
            output_names=names)
        service.data = (JaxContainerSet("test", []) if package == "pisa_tpu"
                        else TorchContainerSet("test", device="cpu"))
        service.setup()
        service.run()
        results[package] = {
            (c.name, k): _host(c[k]) for c in service.data
            for k in ("weighted_aeff", "true_energy", "true_coszen",
                      "weights", "initial_weights", "nubar", "flav")}
    want, got = results["pisa_tpu"], results["pisa_tpu_torch"]
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        np.testing.assert_allclose(got[key], ref, rtol=OUT_RTOL, atol=0,
                                   err_msg=str(key))
    assert sum(want[(n, "weighted_aeff")].size for n in names) > 0


@pytest.mark.parametrize("module,kwargs", [
    ("flux.airs", {"airs_spline": ANY_FILE}),
    ("data.licloader_weighter", {"in_files": ANY_FILE,
                                 "lic_files": ANY_FILE,
                                 "output_names": ["nue_cc"]}),
])
def test_missing_package_message_matches_jax(monkeypatch, module, kwargs):
    monkeypatch.setitem(sys.modules, "photospline", None)
    monkeypatch.setitem(sys.modules, "LeptonWeighter", None)
    messages = []
    for package in ("pisa_tpu", "pisa_tpu_torch"):
        mod = importlib.import_module(f"{package}.stages.{module}")
        cls = getattr(mod, module.split(".")[1])
        with pytest.raises(ImportError) as info:
            cls(**kwargs)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    assert "not installed" in messages[1]
