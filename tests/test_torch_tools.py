"""
The port's host tools against the JAX package's, in fp64 on the CPU
(conftest): ``utils/matrix.py`` (bit for bit on seeded matrices),
``utils/profiler.py`` (the same tprofile records for the same function,
times masked), ``utils/plotter.py`` (the files tests/test_plotter.py
expects, under Agg), ``Map.plot`` (which imports the plotter) and
``utils/hypersurface_plotting.py`` on the port's ``Hypersurface`` (its
curve and 1-sigma band within 1e-12 of the JAX module's on the same
coefficients).
"""

import logging as _pylogging
import os
import re

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg", force=True)

import matplotlib.pyplot as plt  # noqa: E402

from pisa_tpu.core import binning as jax_binning  # noqa: E402
from pisa_tpu.utils import hypersurface as JH  # noqa: E402
from pisa_tpu.utils import hypersurface_plotting as jax_hsp  # noqa: E402
from pisa_tpu.utils import log as jax_log  # noqa: E402
from pisa_tpu.utils import matrix as jax_matrix  # noqa: E402
from pisa_tpu.utils import profiler as jax_profiler  # noqa: E402
from pisa_tpu_torch import ureg  # noqa: E402
from pisa_tpu_torch.core import binning as torch_binning  # noqa: E402
from pisa_tpu_torch.core.binning import (  # noqa: E402
    MultiDimBinning,
    OneDimBinning,
)
from pisa_tpu_torch.core.map import Map, MapSet  # noqa: E402
from pisa_tpu_torch.utils import hypersurface_plotting as hsp  # noqa: E402
from pisa_tpu_torch.utils import log as torch_log  # noqa: E402
from pisa_tpu_torch.utils import matrix  # noqa: E402
from pisa_tpu_torch.utils import profiler  # noqa: E402
from pisa_tpu_torch.utils.hypersurface import Hypersurface  # noqa: E402
from pisa_tpu_torch.utils.plotter import Plotter  # noqa: E402

# the hypersurface plots' curve and band: the same arithmetic, the
# Jacobian in closed form here and by jax.jacfwd there
HS_PLOT_RTOL = 1e-12


# -- matrix ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [2, 5])
def test_matrix_matches_jax_bit_for_bit(seed, n):
    rng = np.random.RandomState(seed)
    a = rng.normal(size=(n, n))
    if seed % 2:
        a = a @ a.T  # positive semi-definite
    assert matrix.is_psd(a) == jax_matrix.is_psd(a)
    got, dist = matrix.fronebius_nearest_psd(a, return_distance=True)
    want, want_dist = jax_matrix.fronebius_nearest_psd(a, return_distance=True)
    np.testing.assert_array_equal(got, want)
    assert dist == want_dist
    assert matrix.is_psd(got)


# -- profiler --------------------------------------------------------------------
def _collect(logger):
    records = []

    class _Collect(_pylogging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = _Collect(level=_pylogging.DEBUG)
    logger.addHandler(handler)
    return records, handler


@pytest.fixture
def tprofile_records():
    """The records of the port's and the JAX package's tprofile loggers
    (neither propagates to root, so caplog sees neither)."""
    loggers = (torch_log.tprofile, jax_log.tprofile)
    levels = [lg.level for lg in loggers]
    collected = []
    for lg in loggers:
        lg.setLevel(_pylogging.DEBUG)
        collected.append(_collect(lg))
    yield tuple(records for records, _ in collected)
    for lg, level, (_, handler) in zip(loggers, levels, collected):
        lg.removeHandler(handler)
        lg.setLevel(level)


def _summed(n):
    total = 0
    for i in range(n):
        total += i
    return total


def _masked(records):
    """The records with their times and shares masked (line numbers, hit
    counts and source lines kept)."""
    return [re.sub(r"\d+\.\d+", "#", r) for r in records]


@pytest.mark.parametrize("decorator", ["profile", "line_profile"])
def test_profiler_logs_the_same_records(tprofile_records, decorator):
    port_records, jax_records = tprofile_records
    port_fn = getattr(profiler, decorator)(_summed)
    jax_fn = getattr(jax_profiler, decorator)(_summed)
    assert port_fn(100) == jax_fn(100) == 4950
    assert port_fn.__name__ == _summed.__name__
    assert port_records and _masked(port_records) == _masked(jax_records)
    if decorator == "line_profile":
        text = "\n".join(port_records)
        assert "line profile" in text and "total += i" in text


# -- plotter -----------------------------------------------------------------------
@pytest.fixture
def mapset():
    e = OneDimBinning("reco_energy", num_bins=6, is_log=True,
                      domain=[5, 50] * ureg.GeV)
    cz = OneDimBinning("reco_coszen", num_bins=5, is_lin=True, domain=[-1, 1])
    binning = MultiDimBinning([e, cz], name="b")
    rng = np.random.RandomState(0)
    maps = [
        Map(
            name=n,
            hist=rng.uniform(1, 10, binning.shape),
            binning=binning,
            error_hist=rng.uniform(0.1, 0.5, binning.shape),
        )
        for n in ("numu_cc", "nue_cc")
    ]
    return MapSet(maps, name="test")


def _written(paths):
    return bool(paths) and all(
        os.path.exists(f) and os.path.getsize(f) > 0 for f in paths)


def test_plot_2d_array(mapset, tmp_path):
    p = Plotter(outdir=str(tmp_path), fmt="png", stamp="test")
    assert _written(p.plot_2d_array(mapset, fname="maps2d"))


def test_plot_1d_and_ratio(mapset, tmp_path):
    p = Plotter(outdir=str(tmp_path), fmt="png", log=False)
    assert _written(p.plot_1d_all(mapset, "reco_energy", fname="proj"))
    assert _written(p.plot_1d_ratio(list(mapset), "reco_energy",
                                    fname="ratio"))


def test_plot_2d_single_and_1d_array(mapset, tmp_path):
    p = Plotter(outdir=str(tmp_path), fmt=["png", "pdf"], log=False)
    paths = p.plot_2d_single(mapset, fname="single")
    assert len(paths) == 4 and _written(paths)
    assert _written(p.plot_1d_array(mapset, "reco_energy", fname="arr1d"))


def test_plot_1d_stack_cmp_slices(mapset, tmp_path):
    p = Plotter(outdir=str(tmp_path), fmt="png", log=False)
    assert _written(p.plot_1d_stack(mapset, "reco_energy", fname="stack"))
    other = MapSet([m * 1.2 for m in mapset], name="scaled")
    assert _written(p.plot_1d_cmp([mapset, other], "reco_energy", fname="cmp",
                                  labels=["nominal", "scaled"]))
    assert _written(p.plot_1d_slices_array([mapset, other], "reco_energy",
                                           fname="slices"))


@pytest.mark.parametrize("dims", [2, 1])
def test_map_plot_writes_a_file(mapset, tmp_path, dims):
    """Map.plot imports utils/plotter.py, which the port lacked (it raised
    ModuleNotFoundError); a 2-D map and a 1-D projection each write a
    file."""
    m = mapset["numu_cc"]
    if dims == 1:
        m = m.project("reco_energy")
    paths = m.plot(fname=f"map{dims}d", outdir=str(tmp_path))
    assert paths == [str(tmp_path / f"map{dims}d.png")] and _written(paths)
    ax = m.plot()  # no file: the axis
    assert ax.get_xlabel() == "reco_energy"
    plt.close("all")


# -- hypersurface plotting -----------------------------------------------------------
TRUTH_SLOPE = {"opt_eff": 0.3, "ice_abs": -0.1}
NOMINAL = {"opt_eff": 1.0, "ice_abs": 0.0}
SYS_VALUES = [
    {"opt_eff": 1.0, "ice_abs": 0.0},
    {"opt_eff": 1.2, "ice_abs": 0.0},
    {"opt_eff": 0.8, "ice_abs": 0.0},
    {"opt_eff": 1.0, "ice_abs": 1.0},
    {"opt_eff": 1.0, "ice_abs": -1.0},
    {"opt_eff": 1.1, "ice_abs": 0.5},
]


def _hs_binning(binning_module, ureg_):
    e = binning_module.OneDimBinning("reco_energy", num_bins=3, is_log=True,
                                     domain=[5, 50] * ureg_.GeV)
    cz = binning_module.OneDimBinning("reco_coszen", num_bins=2, is_lin=True,
                                      domain=[-1, 1])
    return binning_module.MultiDimBinning([e, cz], name="b")


@pytest.fixture(scope="module", params=[False, True], ids=["lin", "log"])
def fitted(request):
    """A hypersurface fitted on the CPU to the datasets of
    tests/test_plotter.py (a quadratic term in ice_abs), and the JAX
    package's with the same coefficients and covariance."""
    from pisa_tpu import ureg as jax_ureg

    binning = _hs_binning(torch_binning, ureg)
    rng = np.random.RandomState(1)
    nominal_hist = rng.uniform(50, 100, binning.shape)
    sys_maps = []
    for pv in SYS_VALUES:
        scale = (1.0 + TRUTH_SLOPE["opt_eff"] * (pv["opt_eff"] - 1.0)
                 + TRUTH_SLOPE["ice_abs"] * pv["ice_abs"]
                 + 0.02 * pv["ice_abs"] ** 2)
        sys_maps.append(Map(name="m", hist=nominal_hist * scale,
                            binning=binning,
                            error_hist=np.sqrt(nominal_hist * scale)))
    funcs = {"opt_eff": "linear", "ice_abs": "quadratic"}
    hs = Hypersurface(binning, ["opt_eff", "ice_abs"], funcs,
                      log=request.param)
    hs.fit(sys_maps[0], NOMINAL, sys_maps, SYS_VALUES, device="cpu")
    jax_hs = JH.Hypersurface(_hs_binning(jax_binning, jax_ureg),
                             ["opt_eff", "ice_abs"], funcs,
                             log=request.param)
    jax_hs.nominal_values = dict(hs.nominal_values)
    jax_hs.intercept = np.array(hs.intercept)
    jax_hs.coeffts = {k: np.array(v) for k, v in hs.coeffts.items()}
    jax_hs.fit_cov_mat = np.array(hs.fit_cov_mat)
    return hs, jax_hs


def test_hypersurface_curve_and_band_match_jax(fitted):
    hs, jax_hs = fitted
    x = np.linspace(0.7, 1.3, 13)
    for b in range(hs.binning.size):
        got = hsp._eval_curve(hs, b, "opt_eff", x, return_band=True)
        want = jax_hsp._eval_curve(jax_hs, b, "opt_eff", x, return_band=True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=HS_PLOT_RTOL,
                                       atol=0)
        assert np.all(got[1] > 0)
        np.testing.assert_array_equal(hsp._eval_curve(hs, b, "opt_eff", x),
                                      got[0])


def test_hypersurface_bin_fit_plots(fitted, tmp_path):
    """The 1-D and 2-D fit-quality plots write files, and the fitted
    linear-space curve at a dataset point reproduces the dataset's scale
    (the log-space surface, exp of a polynomial, only approximates it)."""
    hs, _ = fitted
    fig, ax = plt.subplots()
    hsp.plot_bin_fits(ax, hs, (1, 1), "opt_eff", show_nominal=True,
                      label="datasets", hs_label="fit")
    f1 = str(tmp_path / "hs_1d.png")
    fig.savefig(f1)
    fig, ax = plt.subplots()
    hsp.plot_bin_fits_2d(ax, hs, 3, ["opt_eff", "ice_abs"])
    f2 = str(tmp_path / "hs_2d.png")
    fig.savefig(f2)
    plt.close("all")
    assert os.path.getsize(f1) > 0 and os.path.getsize(f2) > 0

    if not hs.log:
        y = hsp._eval_curve(hs, 3, "opt_eff", np.array([1.2]))
        np.testing.assert_allclose(y, 1.0 + TRUTH_SLOPE["opt_eff"] * 0.2,
                                   rtol=1e-3)
