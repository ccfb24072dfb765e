"""
The port's hypersurfaces (``pisa_tpu_torch/utils/hypersurface.py`` and
``pisa_tpu_torch/scripts/fit_hypersurfaces.py``) against the JAX package's,
in fp64 on the CPU (conftest), on the same synthetic maps made from a seed
with numpy:

- the all-bins Gauss-Newton fit, for every functional form, in log space,
  without normalization, with bins that are not valid: coefficients 1e-10
  relative and covariances 1e-8 relative (each entry) on valid bins, NaN in
  the same places;
- ``evaluate(return_uncertainty=True)``: scales 1e-12 and sigmas 1e-10
  relative, and the scale's autograd gradient against ``jax.grad`` (1e-12
  relative);
- JSON (and interpolated ``.json.bz2``) written by either package loads in
  the other and evaluates the same (1e-12 relative); the data release's CSV
  hyperplanes load the same;
- ``fit_hypersurfaces_from_pipeline`` on ``toy_generalized_llh.cfg`` (the
  JAX package's ``test_fit_apply_roundtrip``) and the interpolated-fit job
  workflow (its ``test_interpolated_fit_job_workflow``, with the
  early-assemble ValueError and the resume).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.core import binning as jax_binning
from pisa_tpu.core import map as jax_map
from pisa_tpu.scripts import fit_hypersurfaces as jax_script
from pisa_tpu.utils import hypersurface as JH
from pisa_tpu_torch import ureg as torch_ureg
from pisa_tpu_torch.core import binning as torch_binning
from pisa_tpu_torch.core import map as torch_map
from pisa_tpu_torch.scripts import fit_hypersurfaces as torch_script
from pisa_tpu_torch.utils import hypersurface as TH

COEFF_RTOL = 1e-10
COV_RTOL = 1e-8
SCALE_RTOL = 1e-12
SIGMA_RTOL = 1e-10
SEED = 7

PACKAGES = {
    "jax": (jax_binning, jax_map, jax_ureg, JH, {}),
    "torch": (torch_binning, torch_map, torch_ureg, TH, {"device": "cpu"}),
}

#: fit cases: the forms of the params, log, norm
CASES = {
    "all_forms": ({"a": "linear", "b": "quadratic", "c": "exponential",
                   "d": "exponential_scaled", "e": "logarithmic"},
                  False, True),
    "log": ({"a": "linear", "b": "quadratic"}, True, True),
    "no_norm": ({"a": "linear", "b": "quadratic"}, False, False),
}


def _binning(package):
    binning, _, ureg, _, _ = PACKAGES[package]
    return binning.MultiDimBinning([
        binning.OneDimBinning("reco_energy", num_bins=5, is_log=True,
                              domain=[5, 50] * ureg.GeV),
        binning.OneDimBinning("reco_coszen", num_bins=4, is_lin=True,
                              domain=[-1, 1]),
    ])


def _truth(pv, nominal):
    """The scale the synthetic maps follow at param values `pv`."""
    d = {k: pv[k] - nominal[k] for k in pv}
    s = 1.0
    s += 0.3 * d.get("a", 0.0)
    s += -0.2 * d.get("b", 0.0) + 0.4 * d.get("b", 0.0) ** 2
    s += np.exp(0.5 * d.get("c", 0.0)) - 1.0
    s += 1.1 * (np.exp(0.2 * d.get("d", 0.0)) - 1.0)
    s += np.log1p(0.3 * d.get("e", 0.0))
    return s


def _datasets(package, forms, seed=SEED):
    """(nominal mapset, its values, sys mapsets, their values, binning): two
    maps of 20 bins, 14 datasets; bin 3 of map "m0" empty at nominal (not
    valid), bin 5 of map "m1" NaN in one dataset (not valid)."""
    _, map_module, _, _, _ = PACKAGES[package]
    binning = _binning(package)
    rng = np.random.RandomState(seed)
    nominal = {k: 1.0 for k in forms}
    points = [dict(nominal)] + [
        {k: 1.0 + rng.uniform(-0.3, 0.3) for k in forms} for _ in range(13)]
    base = {"m0": 1000 * (1 + rng.rand(binning.size)),
            "m1": 300 * (1 + rng.rand(binning.size))}
    base["m0"][3] = 0.0
    noise = rng.randn(len(points), 2, binning.size)
    mapsets = []
    for i, pv in enumerate(points):
        maps = []
        for j, name in enumerate(("m0", "m1")):
            hist = base[name] * _truth(pv, nominal) * (1 + 0.01 * noise[i, j])
            if name == "m1" and i == 4:
                hist[5] = np.nan
            maps.append(map_module.Map(
                name=name, hist=hist.reshape(binning.shape), binning=binning,
                error_hist=np.sqrt(np.abs(hist)).reshape(binning.shape)))
        mapsets.append(map_module.MapSet(maps))
    return mapsets[0], points[0], mapsets[1:], points[1:], binning


def _fit(package, forms, log, norm):
    _, _, _, hs_module, kw = PACKAGES[package]
    nom_ms, nom_pv, sys_ms, sys_pv, binning = _datasets(package, forms)
    return hs_module.fit_hypersurfaces_from_maps(
        nominal_mapset=nom_ms, nominal_param_values=nom_pv,
        sys_mapsets=sys_ms, sys_param_values=sys_pv, binning=binning,
        params=forms, log=log, norm=norm, **kw)


def _assert_fits_equal(want, got):
    assert list(got) == list(want)
    for name in want:
        w, g = want[name], got[name]
        np.testing.assert_array_equal(g.fit_valid, w.fit_valid)
        valid = w.fit_valid
        assert valid.any() and not valid.all()
        wt, gt = w._packed_theta(), g._packed_theta()
        np.testing.assert_array_equal(np.isnan(gt), np.isnan(wt))
        assert np.all(np.isnan(gt[~valid]))
        np.testing.assert_allclose(gt[valid], wt[valid], rtol=COEFF_RTOL,
                                   atol=0, err_msg=name)
        np.testing.assert_array_equal(np.isnan(g.fit_cov_mat),
                                      np.isnan(w.fit_cov_mat))
        np.testing.assert_allclose(g.fit_cov_mat[valid], w.fit_cov_mat[valid],
                                   rtol=COV_RTOL, atol=0, err_msg=name)
        assert g.nominal_values == w.nominal_values
        assert not g.using_legacy_data


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_matches_jax(case):
    forms, log, norm = CASES[case]
    _assert_fits_equal(_fit("jax", forms, log, norm),
                       _fit("torch", forms, log, norm))


def test_fit_method_and_fitter_cache():
    """Hypersurface.fit on one map is the batched fit's; the fitter is
    cached per structure."""
    forms = CASES["log"][0]
    fits = {}
    for package in ("jax", "torch"):
        _, _, _, hs_module, kw = PACKAGES[package]
        nom_ms, nom_pv, sys_ms, sys_pv, binning = _datasets(package, forms)
        hs = hs_module.Hypersurface(binning, list(forms), forms)
        hs.fit(nom_ms["m1"], nom_pv, [nom_ms["m1"]] + [m["m1"] for m in sys_ms],
               [nom_pv] + sys_pv, **kw)
        fits[package] = {"m1": hs}
    _assert_fits_equal(fits["jax"], fits["torch"])
    hs = fits["torch"]["m1"]
    assert hs._fitter() is hs._fitter()
    assert hs._fitter(gn_iterations=5) is not hs._fitter()


def _random_surface(package, log, seed=3):
    """The same Hypersurface in `package`: every form, random coefficients
    and symmetric positive definite covariances, one bin NaN."""
    _, _, _, hs_module, _ = PACKAGES[package]
    forms = CASES["all_forms"][0]
    binning = _binning(package)
    hs = hs_module.Hypersurface(binning, list(forms), forms,
                                nominal_values={k: 1.0 for k in forms},
                                log=log)
    rng = np.random.RandomState(seed)
    n = hs.num_coeffts
    theta = rng.uniform(-0.3, 0.3, (binning.size, n))
    theta[:, 0] += 0.0 if log else 1.0
    theta[2] = np.nan
    hs.intercept = theta[:, 0]
    _, blocks = hs._unpack(theta)
    hs.coeffts = {k: np.array(v) for k, v in blocks.items()}
    m = rng.randn(binning.size, n, n) * 1e-2
    hs.fit_cov_mat = m @ m.transpose(0, 2, 1) + 1e-5 * np.eye(n)
    return hs


@pytest.mark.parametrize("log", [False, True])
def test_evaluate_uncertainty_and_gradient_match_jax(log):
    jhs, ths = _random_surface("jax", log), _random_surface("torch", log)
    pv = {"a": 1.2, "b": 0.8, "c": 1.1, "d": 0.9, "e": 1.3}
    js, ju = (np.asarray(x) for x in jhs.evaluate(pv, return_uncertainty=True))
    ts, tu = ths.evaluate(pv, return_uncertainty=True, device="cpu")
    finite = np.isfinite(js)
    assert finite.sum() == finite.size - 1
    np.testing.assert_array_equal(np.isfinite(ts.numpy()), finite)
    np.testing.assert_allclose(ts.numpy()[finite], js[finite],
                               rtol=SCALE_RTOL, atol=0)
    np.testing.assert_allclose(tu.numpy()[finite], ju[finite],
                               rtol=SIGMA_RTOL, atol=0)
    assert np.all(tu.numpy()[finite] > 0)
    # without a covariance the uncertainty is zero
    ths.fit_cov_mat = None
    assert float(ths.evaluate(pv, True, device="cpu")[1].abs().sum()) == 0

    # the gradient of the finite bins' sum: the JAX package's is NaN when a
    # bin's coefficients are (its where() multiplies NaN by 0 backward), so
    # its reference is the same surface with that bin the identity; the
    # port's, from the surface with the NaN bin, is finite and equal
    names = sorted(pv)
    mask = jnp.asarray(finite)
    jhs.intercept = np.where(finite, jhs.intercept, 0.0 if log else 1.0)
    jhs.coeffts = {k: np.where(finite[:, None], v, 0.0)
                   for k, v in jhs.coeffts.items()}

    def total(values):
        scale = jhs.evaluate(dict(zip(names, values)))
        return jnp.sum(jnp.where(mask, scale, 0.0))

    want = np.asarray(jax.grad(total)(jnp.asarray([pv[k] for k in names])))
    x = torch.tensor([pv[k] for k in names], dtype=torch.float64,
                     requires_grad=True)
    scale, sigma = _random_surface("torch", log).evaluate(
        dict(zip(names, x)), True, device="cpu")
    keep = torch.as_tensor(finite)
    (got,) = torch.autograd.grad(torch.where(keep, scale, 0.0).sum(), x,
                                 retain_graph=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=SCALE_RTOL, atol=0)
    # the uncertainty's gradient is finite too
    (got,) = torch.autograd.grad(torch.where(keep, sigma, 0.0).sum(), x)
    assert torch.isfinite(got).all() and bool((got != 0).any())


def test_json_between_packages(tmp_path):
    """A JSON written by either package loads in the other and evaluates
    the same; the same for interpolated fits in .json.bz2."""
    pv = {"a": 1.2, "b": 0.8, "c": 1.1, "d": 0.9, "e": 1.3}
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        surfaces = {"numu_cc": _random_surface(writer, False),
                    "nue_cc": _random_surface(writer, True, seed=4)}
        path = str(tmp_path / f"{writer}.json")
        PACKAGES[writer][3].save_hypersurfaces(surfaces, path)
        loaded = PACKAGES[reader][3].load_hypersurfaces(path)
        assert list(loaded) == list(surfaces)
        for name, hs in surfaces.items():
            kw_w, kw_r = PACKAGES[writer][4], PACKAGES[reader][4]
            want = np.asarray(hs.evaluate(pv, return_uncertainty=True,
                                          **kw_w)[1])
            got = np.asarray(loaded[name].evaluate(
                pv, return_uncertainty=True, **kw_r)[1])
            np.testing.assert_allclose(got, want, rtol=SCALE_RTOL, atol=0,
                                       equal_nan=True)

        spec = {"deltam31": {"values": [2.0e-3, 2.5e-3, 3.0e-3],
                             "scales_log": False}}
        fits = [_random_surface(writer, False, seed=s) for s in (5, 6, 7)]
        interp = PACKAGES[writer][3].HypersurfaceInterpolator.from_fits(
            spec, fits)
        path = str(tmp_path / f"{writer}_interp.json.bz2")
        PACKAGES[writer][3].save_interpolated_hypersurfaces(
            {"numu_cc": interp}, path)
        back = PACKAGES[reader][3].load_interpolated_hypersurfaces(
            path)["numu_cc"]
        assert back.interpolation_param_names == ["deltam31"]
        for point in (2.2e-3, 2.5e-3, 2.9e-3):
            want = interp.get_hypersurface(deltam31=point)
            got = back.get_hypersurface(deltam31=point)
            np.testing.assert_allclose(got._packed_theta(),
                                       want._packed_theta(), rtol=1e-15)
            np.testing.assert_allclose(
                np.asarray(got.evaluate(pv, True, **PACKAGES[reader][4])[1]),
                np.asarray(want.evaluate(pv, True,
                                         **PACKAGES[writer][4])[1]),
                rtol=SCALE_RTOL, atol=0)


def test_data_release_csv_matches_jax():
    """The data release's hyperplanes (the port reads them with numpy, the
    JAX package with pandas) load as the same legacy linear surfaces
    (1e-12 relative: pandas' default float parser is not always correctly
    rounded)."""
    prototype = "events/IceCube_3y_oscillations/hyperplanes_*.csv.bz2"
    out = {}
    for package, (binning, _, ureg, hs_module, kw) in PACKAGES.items():
        b = binning.MultiDimBinning([
            binning.OneDimBinning(
                "reco_energy", is_log=True,
                bin_edges=[5.62341325, 7.49894209, 10.0, 13.33521432,
                           17.7827941, 23.71373706, 31.6227766, 42.16965034,
                           56.23413252] * ureg.GeV),
            binning.OneDimBinning("reco_coszen", num_bins=8, is_lin=True,
                                  domain=[-1, 1]),
            binning.OneDimBinning("pid", bin_edges=[-0.5, 0.5, 1.5]),
        ], name="dragon_datarelease")
        out[package] = (hs_module.load_hypersurfaces(prototype, b), kw)
    pv = {"ice_absorption": 0.3, "ice_scattering": -0.2,
          "opt_eff_headon": 0.1, "opt_eff_lateral": 25.0,
          "opt_eff_overall": 1.05}
    (want, _), (got, kw) = out["jax"], out["torch"]
    assert list(got) == list(want)
    for name in want:
        assert got[name].using_legacy_data and got[name].func_names == (
            want[name].func_names)
        np.testing.assert_allclose(got[name]._packed_theta(),
                                   want[name]._packed_theta(),
                                   rtol=SCALE_RTOL, atol=0)
        np.testing.assert_allclose(
            got[name].evaluate(pv, **kw).numpy(),
            np.asarray(want[name].evaluate(pv)), rtol=SCALE_RTOL, atol=0)


FIT_CFG = "settings/pipeline/toy_generalized_llh.cfg"
FIT_POINTS = [{"aeff_scale": v} for v in (0.8, 0.9, 1.1, 1.2)]


def test_fit_from_pipeline_matches_jax(tmp_path):
    """fit_hypersurfaces_from_pipeline on toy_generalized_llh.cfg (the JAX
    package's test_fit_apply_roundtrip): the same fits, which
    recover the linear aeff_scale; the port's script writes a file the
    JAX package loads."""
    kw = dict(pipeline_cfg=FIT_CFG, params={"aeff_scale": "linear"},
              nominal_param_values={"aeff_scale": 1.0},
              sys_param_values=FIT_POINTS, norm=True)
    want = jax_script.fit_hypersurfaces_from_pipeline(**kw)
    got = torch_script.fit_hypersurfaces_from_pipeline(device="cpu", **kw)
    assert set(got) == {"nue_cc", "numu_cc"}
    for name in want:
        valid = want[name].fit_valid
        np.testing.assert_array_equal(got[name].fit_valid, valid)
        np.testing.assert_allclose(got[name]._packed_theta()[valid],
                                   want[name]._packed_theta()[valid],
                                   rtol=COEFF_RTOL, atol=1e-14)
        np.testing.assert_allclose(got[name].coeffts["aeff_scale"][valid, 0],
                                   1.0, atol=1e-4)

    import json

    cfg = dict(pipeline_cfg=FIT_CFG, params={"aeff_scale": "linear"},
               nominal_dataset={"param_values": {"aeff_scale": 1.0}},
               sys_datasets=[{"param_values": p} for p in FIT_POINTS])
    (tmp_path / "fit.json").write_text(json.dumps(cfg))
    out = str(tmp_path / "hs.json")
    assert torch_script.main([str(tmp_path / "fit.json"), "-o", out,
                              "--device", "cpu"]) == 0
    loaded = JH.load_hypersurfaces(out)
    for name in want:
        np.testing.assert_array_equal(loaded[name]._packed_theta(),
                                      got[name]._packed_theta())


def test_interpolated_job_workflow_matches_jax(tmp_path):
    """prepare -> run one job -> early assemble raises -> resume all ->
    assemble -> load, in both packages (the JAX package's
    test_interpolated_fit_job_workflow); the assembled files give
    the same hypersurfaces, and each package loads the other's."""
    fit_cfg = {
        "pipeline_cfg": FIT_CFG,
        "params": {"aeff_scale": "linear"},
        "nominal_dataset": {"param_values": {"aeff_scale": 1.0}},
        "sys_datasets": [{"param_values": {"aeff_scale": 0.8}},
                         {"param_values": {"aeff_scale": 1.2}}],
        "norm": True,
    }
    spec = {"nu_nc_norm": {"values": [0.8, 1.0, 1.2], "scales_log": False}}
    outputs = {}
    for package, hs_module, kw in (("jax", JH, {}),
                                   ("torch", TH, {"device": "cpu"})):
        fit_dir = str(tmp_path / package)
        assert hs_module.prepare_interpolated_fit(fit_dir, spec, fit_cfg) == 3
        assert hs_module.get_incomplete_job_idx(fit_dir) == [0, 1, 2]
        hs_module.run_interpolated_fit(fit_dir, 0, **kw)
        with pytest.raises(ValueError):
            hs_module.assemble_interpolated_fits(
                fit_dir, str(tmp_path / f"{package}_early.json"))
        assert hs_module.get_incomplete_job_idx(fit_dir) == [1, 2]
        for job in range(3):
            hs_module.run_interpolated_fit(fit_dir, job,
                                           skip_successful=True, **kw)
        assert hs_module.get_incomplete_job_idx(fit_dir) == []
        out = str(tmp_path / f"{package}_interpolated.json.bz2")
        hs_module.assemble_interpolated_fits(fit_dir, out)
        outputs[package] = out
    scales = []
    for reader, hs_module, kw in (("jax", JH, {}),
                                  ("torch", TH, {"device": "cpu"})):
        for path in outputs.values():
            interps = hs_module.load_interpolated_hypersurfaces(path)
            assert set(interps) == {"nue_cc", "numu_cc"}
            hs = interps["numu_cc"].get_hypersurface(nu_nc_norm=1.05)
            valid = hs.fit_valid
            scale = np.asarray(hs.evaluate({"aeff_scale": 1.15}, **kw))
            assert valid.any()
            np.testing.assert_allclose(scale[valid], 1.15, atol=1e-3)
            scales.append(scale)
    for scale in scales[1:]:
        np.testing.assert_allclose(scale, scales[0], rtol=COEFF_RTOL,
                                   atol=1e-14)
