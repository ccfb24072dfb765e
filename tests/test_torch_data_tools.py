"""
The port's data-preparation tools against the JAX package's, in float64 on
the CPU, with seeded numpy inputs:

- ``data.meows_loader`` through the service matrix (its ``init_test``
  writes its synthetic file with the port's HDF5 writer): every output
  within 1e-12 relative of the JAX service's, the matrix's status "ok";
- ``resources/events/make_toy_3y_mc.py``: its events equal the committed
  ``neutrino_mc.csv.bz2`` value for value (values, not bytes: bz2 and
  pandas differ between machines), and ``make`` writes what the JAX
  ``make`` writes;
- ``utils/cross_sections.py:CrossSections`` read in place from
  ``pisa_tpu/resources/cross_sections/``: every table and interpolated
  value equal;
- ``utils/spline.py``: ``Spline``, ``CombinedSpline`` on the port's maps
  and ``spline_smooth``, equal to 1e-12;
- ``scripts/make_nufit_theta23_spline_priors.py`` on seeded NuFit-style
  files: every knot and coefficient equal;
- ``scripts/create_barr_sys_tables_mceq.py``: the Barr blocks, envelope
  and modification matrices equal, and ``main`` exits as the JAX one
  without ``MCEq``.
"""

import gzip
import importlib.util
import os

import numpy as np
import pytest

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.core import binning as jax_binning
from pisa_tpu.core.container import ContainerSet as JaxContainerSet
from pisa_tpu.core.map import Map as JaxMap
from pisa_tpu.scripts import create_barr_sys_tables_mceq as jax_barr
from pisa_tpu.scripts import make_nufit_theta23_spline_priors as jax_nufit
from pisa_tpu.stages.data import meows_loader as jax_meows
from pisa_tpu.testing import service_matrix as JSM
from pisa_tpu.utils import spline as jax_spline
from pisa_tpu.utils.cross_sections import CrossSections as JaxCrossSections
from pisa_tpu.utils.fileio import from_file as jax_from_file
from pisa_tpu_torch import ureg
from pisa_tpu_torch.core import binning
from pisa_tpu_torch.core.container import ContainerSet
from pisa_tpu_torch.core.map import Map
from pisa_tpu_torch.scripts import create_barr_sys_tables_mceq as barr
from pisa_tpu_torch.scripts import make_nufit_theta23_spline_priors as nufit
from pisa_tpu_torch.stages.data import meows_loader
from pisa_tpu_torch.testing import service_matrix as TSM
from pisa_tpu_torch.utils import spline
from pisa_tpu_torch.utils.cross_sections import CrossSections
from pisa_tpu_torch.utils.fileio import from_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12
MEOWS_KEYS = ("weighted_aeff", "weights", "initial_weights", "astro_weights",
              "total_column_depth", "true_bjorkenx", "true_bjorkeny",
              "true_energy", "true_coszen", "reco_energy", "reco_coszen",
              "pid")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- data.meows_loader ------------------------------------------------------------------
def test_meows_loader_matches_jax():
    """Both packages' init_test services (the same synthetic file, each
    written by its package's to_hdf), set up and run: the same containers,
    every key within RTOL, and the aux data."""
    outputs = {}
    for name, module, data in (
            ("jax", jax_meows, JaxContainerSet("test", [])),
            ("port", meows_loader, ContainerSet("test", device="cpu"))):
        service = module.init_test()
        service.data = data
        service.setup()
        service.run()
        outputs[name] = {
            c.name: ({k: np.asarray(c[k]) for k in MEOWS_KEYS},
                     c["nubar"], c["flav"])
            for c in service.data}
    assert sorted(outputs["port"]) == sorted(outputs["jax"]) == [
        "nue", "nutau_bar"]
    for cname, (want, nubar, flav) in outputs["jax"].items():
        got, got_nubar, got_flav = outputs["port"][cname]
        assert (got_nubar, got_flav) == (nubar, flav)
        for key, ref in want.items():
            value = got[key].detach().numpy() if hasattr(got[key], "detach") \
                else got[key]
            assert value.shape == ref.shape == (8,), key
            np.testing.assert_allclose(value, ref, rtol=RTOL, atol=0,
                                       err_msg=f"{cname} {key}")


def test_meows_loader_in_the_service_matrix():
    """The port's matrix runs the new service (events "ok", map "n/a"),
    as the JAX package's does."""
    assert "meows_loader" in TSM.SOURCE_SERVICES
    assert ("data", "meows_loader") not in JSM.MAP_MODE_SERVICES
    assert TSM.run_service("data", "meows_loader", "events",
                           device="cpu") == "ok"
    assert TSM.run_service("data", "meows_loader", "map",
                           device="cpu") == "n/a"


# -- make_toy_3y_mc -----------------------------------------------------------------------
PORT_TOY = os.path.join(ROOT, "pisa_tpu_torch", "resources", "events",
                        "make_toy_3y_mc.py")
JAX_TOY = os.path.join(ROOT, "pisa_tpu", "resources", "events",
                       "make_toy_3y_mc.py")


def test_toy_3y_mc_equals_the_committed_file():
    """The 240,000 events, column by column, equal the committed CSV's
    values exactly (parsed with round-trip precision)."""
    import pandas as pd

    toy = _load(PORT_TOY, "port_make_toy_3y_mc")
    got = toy.toy_columns()
    want = pd.read_csv(os.path.join(
        ROOT, "pisa_tpu", "resources", "events", "IceCube_3y_oscillations",
        "neutrino_mc.csv.bz2"), float_precision="round_trip")
    assert list(want.columns) == list(toy.COLUMNS)
    assert len(want) == 240_000
    for column in toy.COLUMNS:
        assert got[column].dtype == want[column].dtype, column
        np.testing.assert_array_equal(got[column], want[column].to_numpy(),
                                      err_msg=column)


def test_toy_3y_mc_make_writes_what_jax_writes(tmp_path, monkeypatch):
    """make(path) of both scripts at 50 events a category: the same
    values (the port draws in the JAX script's order)."""
    import pandas as pd

    frames = []
    for path, name in ((PORT_TOY, "port_toy"), (JAX_TOY, "jax_toy")):
        module = _load(path, name)
        monkeypatch.setattr(module, "N_PER_CATEGORY", 50)
        out = str(tmp_path / f"{name}.csv.bz2")
        module.make(out)
        frames.append(pd.read_csv(out, float_precision="round_trip"))
    assert frames[0].equals(frames[1])
    assert len(frames[0]) == 600


# -- CrossSections -----------------------------------------------------------------------
def test_cross_sections_match_jax():
    got, want = CrossSections(), JaxCrossSections()
    assert [str(f) for f in got.flavints] == [str(f) for f in want.flavints]
    np.testing.assert_array_equal(got.energy, want.energy)
    energies = np.random.RandomState(1).uniform(0.5, 200.0, 50)
    for fi in want.flavints:
        np.testing.assert_array_equal(got[str(fi)], want[str(fi)])
        np.testing.assert_array_equal(got.get_xs_value(str(fi), energies),
                                      want.get_xs_value(str(fi), energies))
    np.testing.assert_array_equal(
        got.get_xs_ratio_value("numu_cc", "numubar_cc", energies),
        want.get_xs_ratio_value("numu_cc", "numubar_cc", energies))
    np.testing.assert_array_equal(got.total("nutau", energies),
                                  want.total("nutau", energies))
    with pytest.raises(ValueError):
        CrossSections(ver="genie_0.0")


# -- Spline, CombinedSpline, spline_smooth ------------------------------------------------------
def _spline_inputs(binning_mod, units):
    b = binning_mod.MultiDimBinning([
        binning_mod.OneDimBinning("true_energy", num_bins=12, is_log=True,
                                  domain=[1, 100] * units.GeV),
        binning_mod.OneDimBinning("true_coszen", num_bins=5, is_lin=True,
                                  domain=[-1, 1])], name="b")
    return b


def _eval_spl(map_cls):
    def eval_spl(spl, b, name=""):
        e = np.asarray(b["true_energy"].weighted_centers.magnitude)
        cz = np.asarray(b["true_coszen"].weighted_centers.magnitude)
        return map_cls(name=name, hist=spl(e)[:, None] * (1 + cz[None, :]),
                       binning=b)
    return eval_spl


def test_splines_match_jax():
    """Spline.get_map, get_integrated_map and CombinedSpline.get_mapset on
    both packages' maps; spline_smooth of seeded noisy columns."""
    def power(k):
        return lambda e: e ** -k

    made = {}
    for name, module, map_cls, b in (
            ("jax", jax_spline, JaxMap, _spline_inputs(jax_binning, jax_ureg)),
            ("port", spline, Map, _spline_inputs(binning, ureg))):
        splines = [module.Spline(fi, power(k), _eval_spl(map_cls))
                   for k, fi in ((2.0, "numu_cc"), (1.5, "nue_nc"))]
        combined = module.CombinedSpline(splines)
        made[name] = (
            [s.tex for s in splines], combined.names,
            [m.hist for m in combined.get_mapset(b)],
            splines[0].get_integrated_map(b).hist)
    got, want = made["port"], made["jax"]
    assert got[0] == want[0] and got[1] == want[1] == ["numu_cc", "nue_nc"]
    for g, w in zip(got[2] + [got[3]], want[2] + [want[3]]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=RTOL)

    rng = np.random.RandomState(0)
    noisy = rng.normal(size=(20, 3)) * 0.05 + np.linspace(0, 1, 20)[:, None]
    errors = np.full(noisy.shape, 0.05)
    results = []
    for module, b_mod, units in ((jax_spline, jax_binning, jax_ureg),
                                 (spline, binning, ureg)):
        coarse = b_mod.OneDimBinning("e", num_bins=20, is_lin=True,
                                     domain=[0, 10])
        fine = b_mod.OneDimBinning("e", num_bins=37, is_lin=True,
                                   domain=[0, 10])
        results.append([
            module.spline_smooth(noisy, coarse, fine, axis=0,
                                 smooth_factor=0.5, errors=errors),
            module.spline_smooth(noisy.T, coarse, fine, axis=1,
                                 smooth_factor=0.5)])
    for g, w in zip(results[1], results[0]):
        np.testing.assert_allclose(g, w, rtol=RTOL)
    assert results[1][0].shape == (37, 3) and results[1][1].shape == (3, 37)


# -- NuFit theta23 spline priors ------------------------------------------------------------------
def _fake_nufit_file(path, s2_best, seed, offset=0.0):
    rng = np.random.RandomState(seed)
    s2 = np.linspace(0.3, 0.7, 81)
    dchi2 = (s2 - s2_best) ** 2 / 0.01 + offset + rng.uniform(0, 0.1, 81)
    with gzip.open(path, "wt") as f:
        f.write("# some header\n")
        f.write(nufit.T23_SECTION + "\n")
        for x, y in zip(s2, dchi2):
            f.write(f"{x:.6f} {y:.6f}\n")
        f.write("# other section\n0.5 99.0\n")


def test_nufit_priors_match_jax(tmp_path):
    """Every prior file of both scripts (standard, shifted, minimised):
    the same names, knots, coefficients and degree; main(argv) too."""
    io_path, no_path = str(tmp_path / "v99.io.gz"), str(tmp_path / "v99.no.gz")
    _fake_nufit_file(io_path, 0.58, 1, offset=2.0)
    _fake_nufit_file(no_path, 0.55, 2)
    got = nufit.build_spline_priors(io_path, no_path, str(tmp_path / "port"),
                                    shifted=True, minimised=True)
    want = jax_nufit.build_spline_priors(io_path, no_path,
                                         str(tmp_path / "jax"),
                                         shifted=True, minimised=True)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    assert len(got) == 3
    for g_path, w_path in zip(got, want):
        g, w = from_file(g_path), jax_from_file(w_path)
        assert sorted(g) == sorted(w)
        for name in w:
            assert g[name]["deg"] == w[name]["deg"] == 3
            assert g[name]["units"] == w[name]["units"]
            for key in ("knots", "coeffs"):
                np.testing.assert_array_equal(np.asarray(g[name][key]),
                                              np.asarray(w[name][key]))
    nufit.main(["-io", io_path, "-no", no_path, "--outdir",
                str(tmp_path / "cli"), "--version", "v99"])
    assert os.path.isfile(str(tmp_path / "cli"
                              / "nufitv99standardtheta23splines.json"))


# -- Barr blocks ----------------------------------------------------------------------------------
def test_barr_math_matches_jax():
    """The blocks, the envelope of every block at seeded energies and each
    block's modification matrix on a seeded (x, E) grid: equal."""
    assert barr.BARR_BLOCKS == jax_barr.BARR_BLOCKS
    rng = np.random.RandomState(6)
    energy = np.sort(10 ** rng.uniform(-1, 6, 40))
    n = 16
    e_grid = np.logspace(-1, 5, n)
    x_mat = np.triu(rng.uniform(0, 1.2, (n, n)))
    for block in barr.BARR_BLOCKS:
        np.testing.assert_array_equal(
            barr.barr_envelope(energy, block, 0.3),
            jax_barr.barr_envelope(energy, block, 0.3))
        np.testing.assert_array_equal(
            barr.block_mod_matrix(x_mat, e_grid, block, -0.2),
            jax_barr.block_mod_matrix(x_mat, e_grid, block, -0.2))


def test_barr_tables_exit_without_mceq():
    """Neither package has MCEq here: both mains exit naming it."""
    for module in (barr, jax_barr):
        with pytest.raises(SystemExit, match="MCEq"):
            module.main(["--barr-blocks", "a"])
