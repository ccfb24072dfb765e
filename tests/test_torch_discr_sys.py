"""
The port's detector-systematics services against the JAX package's, in
fp64 on the CPU (conftest), on the same inputs:

- ``discr_sys.hypersurfaces`` with ``propagate_uncertainty`` and with
  ``interpolated`` fits (JSON written by the JAX package) at the end of
  ``example.cfg`` (12 categories from the repo's HDF5 events file, prob3's
  grid cut to 20x20): the port's eager
  maps (per container) and its stacked compiled template's against the JAX
  package's eager maps, 'errors' included, 1e-10 of each map's largest bin;
  the compiled value_and_grad of mod_chi2 (value 1e-9, gradient 1e-8
  relative: inside ``tests/test_rate_defer.py``'s 5e-5 and 5e-4); a free
  interpolation param makes both packages' compiled templates raise
  TypeError at their first call, a fixed one works in both;
- ``discr_sys.csv_hypersurfaces`` through both packages' service harness
  (weights 1e-10 relative), its gradient in dm31 (the port's autograd
  against central differences of the JAX package's piecewise-linear
  interpolation, 1e-7 relative), and on example.cfg with deltam31 free
  in the port's stacked compiled template (its maps against the JAX
  package's eager maps, 1e-10);
- ``discr_sys.ultrasurfaces`` from a CSV and a feather table (weights 1e-10
  relative; the port's matched rows equal sklearn's KDTree's);
- ``background.atm_muons``, and the four services in the port's service
  matrix.
"""

import importlib

import numpy as np
import pytest
import torch

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.config.parser import parse_pipeline_config as jax_parse
from pisa_tpu.core import param as jax_param
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu.testing import service_matrix as JSM
from pisa_tpu.utils import hypersurface as JH
from pisa_tpu_torch import ureg as torch_ureg
from pisa_tpu_torch.config.parser import parse_pipeline_config as torch_parse
from pisa_tpu_torch.core import param as torch_param
from pisa_tpu_torch.core.pipeline import Pipeline as TorchPipeline
from pisa_tpu_torch.testing import service_matrix as TSM
from pisa_tpu_torch.units import Quantity

MAP_TOL = 1e-10
WEIGHT_RTOL = 1e-10
VALUE_RTOL = 1e-9
GRAD_RTOL = 1e-8
FD_RTOL = 1e-7
SEED = 42

EXAMPLE_CFG = "settings/pipeline/example.cfg"
LINKS = {
    "nue_cc+nuebar_cc": ["nue_cc", "nuebar_cc"],
    "numu_cc+numubar_cc": ["numu_cc", "numubar_cc"],
    "nutau_cc+nutaubar_cc": ["nutau_cc", "nutaubar_cc"],
    "nu_nc+nubar_nc": ["nue_nc", "numu_nc", "nutau_nc", "nuebar_nc",
                       "numubar_nc", "nutaubar_nc"],
}
HS_FORMS = {"hs_a": "linear", "hs_b": "quadratic"}
DM31_GRID = [2.3e-3, 2.5e-3, 2.7e-3]
#: prob3's calc grid cut from 200x200 to this squared
CALC_GRID_BINS = 20

PACKAGES = {
    "jax": (jax_parse, jax_param, jax_ureg, JaxPipeline, {}),
    "torch": (torch_parse, torch_param, torch_ureg, TorchPipeline,
              {"device": "cpu"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch's CPU ops on one thread: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _surface(binning, rng):
    """A JAX-package Hypersurface over `binning`: HS_FORMS, nominal 1,
    random coefficients and covariances, two bins NaN."""
    hs = JH.Hypersurface(binning, list(HS_FORMS), HS_FORMS,
                         nominal_values=dict.fromkeys(HS_FORMS, 1.0))
    n = hs.num_coeffts
    theta = rng.uniform(-0.5, 0.5, (binning.size, n))
    theta[:, 0] += 1.0
    theta[[7, 150]] = np.nan
    hs.intercept = theta[:, 0]
    _, blocks = hs._unpack(theta)
    hs.coeffts = {k: np.array(v) for k, v in blocks.items()}
    m = rng.randn(binning.size, n, n) * 0.05
    hs.fit_cov_mat = m @ m.transpose(0, 2, 1)
    hs.fit_cov_mat[[7, 150]] = np.nan
    return hs


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The JAX package's fitted-hypersurfaces JSON and interpolated
    .json.bz2 over example.cfg's output binning, and csv_hypersurfaces files
    over it at
    DM31_GRID."""
    tmp = tmp_path_factory.mktemp("discr_sys")
    binning = jax_parse(EXAMPLE_CFG)["pipeline"]["output_binning"]
    rng = np.random.RandomState(SEED)
    out = {"json": str(tmp / "hs.json"),
           "json_identity": str(tmp / "hs_identity.json"),
           "interpolated": str(tmp / "hs_interp.json.bz2")}
    surfaces = {g: _surface(binning, rng) for g in LINKS}
    JH.save_hypersurfaces(surfaces, out["json"])
    # the same with the bins that are not finite the identity surface
    for hs in surfaces.values():
        finite = np.isfinite(hs._packed_theta()).all(axis=1)
        hs.intercept = np.where(finite, hs.intercept, 1.0)
        hs.coeffts = {k: np.where(finite[:, None], v, 0.0)
                      for k, v in hs.coeffts.items()}
        hs.fit_cov_mat = np.where(finite[:, None, None], hs.fit_cov_mat, 0.0)
    JH.save_hypersurfaces(surfaces, out["json_identity"])
    spec = {"deltam31": {"values": DM31_GRID, "scales_log": False}}
    JH.save_interpolated_hypersurfaces(
        {g: JH.HypersurfaceInterpolator.from_fits(
            spec, [_surface(binning, rng) for _ in DM31_GRID])
         for g in LINKS}, out["interpolated"])
    import pandas as pd

    out["csv"] = []
    for g in LINKS:
        frames = []
        for dm31 in DM31_GRID:
            frames.append(pd.DataFrame({
                "intercept": 1 + rng.uniform(-0.2, 0.2, binning.size),
                "intercept_sigma": rng.uniform(0, 0.05, binning.size),
                "hs_a": rng.uniform(-0.5, 0.5, binning.size),
                "hs_b": rng.uniform(-0.5, 0.5, binning.size),
                "deltam31": np.full(binning.size, dm31),
            }))
        frames[0].loc[5, "hs_a"] = np.nan  # a bin whose fit failed
        path = str(tmp / f"hs_{g}.csv")
        pd.concat(frames).to_csv(path, index=False)
        out["csv"].append(path)
    return out


def _example_config(package, files, variant, dm31_free=False,
                    json="json"):
    """example.cfg (prob3's calc grid cut to CALC_GRID_BINS squared) with a
    detector-systematics stage at its end:
    variant "uncertainty" (fitted JSON, propagate_uncertainty), "plain"
    (fitted JSON), "interpolated" (over deltam31) or "csv"
    (csv_hypersurfaces over deltam31); hs_a, hs_b free at 1.1, 0.95."""
    parse, param, ureg, _, _ = PACKAGES[package]
    cfg = parse(EXAMPLE_CFG)
    binning = importlib.import_module(
        f"{'pisa_tpu' if package == 'jax' else 'pisa_tpu_torch'}.core.binning")
    calc_grid = binning.MultiDimBinning([
        binning.OneDimBinning("true_energy", num_bins=CALC_GRID_BINS,
                              is_log=True, domain=[1, 1000] * ureg.GeV),
        binning.OneDimBinning("true_coszen", num_bins=CALC_GRID_BINS,
                              is_lin=True, domain=[-1, 1]),
    ], name="calc_grid")
    cfg[("osc", "prob3")]["calc_mode"] = calc_grid
    grid = cfg["pipeline"]["output_binning"]
    params = [param.Param(name, value * ureg.dimensionless,
                          range=(0.5, 1.5) * ureg.dimensionless,
                          is_fixed=False)
              for name, value in (("hs_a", 1.1), ("hs_b", 0.95))]
    dm31 = cfg[("osc", "prob3")]["params"].get("deltam31", "nh")
    dm31.is_fixed = not dm31_free
    settings = {"calc_mode": grid, "apply_mode": grid, "links": LINKS,
                "error_method": "sumw2"}
    if variant == "csv":
        settings.update(fit_results_file=",".join(files["csv"]),
                        nominal_systematics={"hs_a": 1.0, "hs_b": 1.0},
                        inter_param="deltam31")
        params.append(dm31)
        key = ("discr_sys", "csv_hypersurfaces")
    else:
        key = ("discr_sys", "hypersurfaces")
        settings["fit_results_file"] = files[
            "interpolated" if variant == "interpolated" else json]
        if variant == "uncertainty":
            settings["propagate_uncertainty"] = True
        if variant == "interpolated":
            settings["interpolated"] = True
            params.append(dm31)
    settings["params"] = param.ParamSet(params)
    cfg[key] = settings
    return cfg


def _maps_rel(got, want):
    """Worst |got - want| relative to each map's largest |bin|, errors
    included where the reference has them."""
    worst = 0.0
    for m in want:
        g = got[m.name]
        for w_hist, g_hist in ((m.hist, g.hist),
                               (m.error_hist, g.error_hist)):
            if w_hist is None:
                continue
            w_hist, g_hist = np.asarray(w_hist), np.asarray(g_hist)
            assert np.all(np.isfinite(g_hist)), m.name
            worst = max(worst, float(np.abs(g_hist - w_hist).max()
                                     / np.abs(w_hist).max()))
    return worst


def _template_maps(ct):
    """The compiled template's maps at its current values."""
    return ct.get_outputs(ct.current_rescaled_values())


@pytest.mark.parametrize("variant", ["uncertainty", "plain", "interpolated"])
def test_hypersurfaces_stage_matches_jax(files, variant):
    """Eager, compiled per container and compiled stacked, against the JAX
    package's eager maps (errors included); the hypersurfaces move the
    maps."""
    want = JaxPipeline(_example_config("jax", files, variant)).get_outputs()
    pipeline = TorchPipeline(_example_config("torch", files, variant),
                             device="cpu")
    got = pipeline.get_outputs()
    assert _maps_rel(got, want) <= MAP_TOL
    ct = pipeline.compile()
    assert ct.stacked
    assert _maps_rel(_template_maps(ct), want) <= MAP_TOL
    assert _maps_rel(_template_maps(pipeline.compile(stack=False)),
                     want) <= MAP_TOL
    if variant == "uncertainty":
        assert all(m.error_hist is not None for m in got)
    if variant == "interpolated":
        # at another point between the grid values: another surface
        pipeline.params["deltam31"].value = 2.6e-3 * torch_ureg.eV**2
        jax_p = JaxPipeline(_example_config("jax", files, variant))
        jax_p.params["deltam31"].value = 2.6e-3 * jax_ureg.eV**2
        assert _maps_rel(pipeline.get_outputs(), jax_p.get_outputs()) <= (
            MAP_TOL)
    plain = TorchPipeline(EXAMPLE_CFG, device="cpu").get_outputs()
    assert max(abs(float(got[m.name].hist.sum() / m.hist.sum()) - 1)
               for m in plain) > 1e-3


def test_hypersurfaces_value_and_grad_match_jax(files):
    """The compiled mod_chi2 value_and_grad with hs_a, hs_b free (the
    others fixed, so that the JAX package traces the hypersurfaces stage
    alone) and propagate_uncertainty on, in both packages. The JAX
    package's gradient is NaN where a bin's coefficients are (its where()
    multiplies NaN by 0 backward): its reference runs on the same surfaces
    with those bins the identity, which give the same values; the port's,
    on the surfaces with the NaN bins, is finite and equal."""
    jax_p = JaxPipeline(_example_config("jax", files, "uncertainty",
                                        json="json_identity"))
    data = {m.name: np.asarray(m.hist) * 1.05 for m in jax_p.get_outputs()}
    pipeline = TorchPipeline(_example_config("torch", files, "uncertainty"),
                             device="cpu")
    for p in (*jax_p.params, *pipeline.params):
        p.is_fixed = p.name not in HS_FORMS
    jct = jax_p.compile()
    ct = pipeline.compile()
    assert ct.free_names == list(jct.free_names) == list(HS_FORMS)
    assert ct.stacked
    v = ct.current_rescaled_values() + 0.03
    _, jvg = jct.build_objective(data, "mod_chi2")
    want_value, want_grad = (np.asarray(x) for x in jvg(v))
    _, vg = ct.build_objective(data, "mod_chi2")
    value, grad = vg(v)
    np.testing.assert_allclose(float(value), want_value, rtol=VALUE_RTOL)
    assert torch.isfinite(grad).all()
    np.testing.assert_allclose(grad.detach().numpy(), want_grad,
                               rtol=GRAD_RTOL, atol=0)
    for name in ("hs_a", "hs_b"):
        assert want_grad[list(jct.free_names).index(name)] != 0


def test_interpolated_compile_behaviour(files):
    """The JAX package interpolates on the host: its compiled template
    raises TypeError (TracerArrayConversionError) at the first call when
    deltam31 is free and works when it is fixed. The port does the same."""
    for package in ("jax", "torch"):
        _, _, _, pipeline_cls, kw = PACKAGES[package]
        pipeline = pipeline_cls(_example_config(package, files, "interpolated",
                                            dm31_free=True), **kw)
        ct = pipeline.compile()
        assert "deltam31" in ct.free_names
        with pytest.raises(TypeError):
            ct(ct.current_rescaled_values())
    want = JaxPipeline(_example_config("jax", files,
                                   "interpolated")).get_outputs()
    pipeline = TorchPipeline(_example_config("torch", files, "interpolated"),
                             device="cpu")
    ct = pipeline.compile()
    assert "deltam31" not in ct.free_names
    stage = pipeline["discr_sys.hypersurfaces"]
    assert _maps_rel(_template_maps(ct), want) <= MAP_TOL
    surfaces = stage._interp_surfaces
    assert _maps_rel(_template_maps(ct), want) <= MAP_TOL
    # the point did not move: the same surfaces, uploaded once
    assert stage._interp_surfaces is surfaces
    assert len(stage._stacked_coeffts) == 1


def _harness(package, stage_name, service_name, mode="events", service=None):
    """The service (init_test's, or `service`) with the harness's
    synthetic data for SEED."""
    harness, kw = (JSM, {}) if package == "jax" else (TSM, {"device": "cpu"})
    if service is None:
        module = importlib.import_module(
            f"{'pisa_tpu' if package == 'jax' else 'pisa_tpu_torch'}"
            f".stages.{stage_name}.{service_name}")
        service = module.init_test()
    rng = np.random.RandomState(SEED)
    if mode == "map":
        service.calc_mode = harness.TEST_BINNING
        service.data = harness.make_map_data(service, rng, **kw)
    else:
        service.data = harness.make_events_data(service, rng, **kw)
    return service


def _weights(service):
    return {c.name: np.asarray(c["weights"]) if not isinstance(
        c["weights"], torch.Tensor) else c["weights"].detach().numpy()
        for c in service.data}


def _run_both(stage_name, service_name, prepare=None):
    out = []
    for package in ("jax", "torch"):
        service = _harness(package, stage_name, service_name)
        if prepare is not None:
            prepare(service)
        service.setup()
        service.run()
        out.append(_weights(service))
    return out


def _assert_weights(want, got, moved=True):
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.all(np.isfinite(got[name]))
        np.testing.assert_allclose(got[name], want[name], rtol=WEIGHT_RTOL,
                                   atol=0, err_msg=name)
    if moved:
        assert any(not np.allclose(w, 1.0) for w in got.values())


@pytest.mark.parametrize("service", [("discr_sys", "hypersurfaces"),
                                     ("discr_sys", "csv_hypersurfaces"),
                                     ("background", "atm_muons")])
def test_service_matches_jax(service):
    _assert_weights(*_run_both(*service))


def test_csv_hypersurfaces_dm31_gradient():
    """d(weights)/d(dm31) by autograd through the port's interpolation on
    the device against central differences of the JAX package's (linear
    between grid values, so exact but for rounding)."""
    x0, h = 3.03e-3, 1e-6  # inside one interval of hs_test.csv's grid
    sums = []
    for x in (x0 + h, x0 - h):
        service = _harness("jax", "discr_sys", "csv_hypersurfaces")
        service.params["dm31"].value = x * jax_ureg.eV**2
        service.setup()
        service.run()
        sums.append(sum(float(w.sum()) for w in _weights(service).values()))
    want = (sums[0] - sums[1]) / (2 * h)
    service = _harness("torch", "discr_sys", "csv_hypersurfaces")
    service.setup()
    x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
    service.params["dm31"]._value = Quantity(x, torch_ureg.eV**2)
    service._template_mode = True
    service.run()
    total = sum(c["weights"].sum() for c in service.data)
    (grad,) = torch.autograd.grad(total, x)
    assert want != 0
    np.testing.assert_allclose(float(grad), want, rtol=FD_RTOL)


def test_csv_hypersurfaces_free_dm31_in_template(files):
    """csv_hypersurfaces on example.cfg with deltam31 free: the port's
    stacked compiled template interpolates on the device, against the JAX
    package's eager maps (at deltam31's value, between grid values; a bin
    with a NaN slope scales by 1 in both); its gradient in deltam31 is
    finite."""
    want = JaxPipeline(_example_config("jax", files, "csv")).get_outputs()
    pipeline = TorchPipeline(_example_config("torch", files, "csv",
                                         dm31_free=True), device="cpu")
    assert _maps_rel(pipeline.get_outputs(), want) <= MAP_TOL
    ct = pipeline.compile()
    assert ct.stacked and "deltam31" in ct.free_names
    assert _maps_rel(_template_maps(ct), want) <= MAP_TOL
    data = {m.name: np.asarray(m.hist) * 1.05 for m in want}
    _, vg = ct.build_objective(data, "mod_chi2")
    _, grad = vg(ct.current_rescaled_values())
    assert torch.isfinite(grad).all()
    assert float(grad[ct.free_names.index("deltam31")]) != 0


def _us_table(path_csv, path_feather):
    """A gradient table over the harness's variables with distinct points
    (no ties between neighbours), written as CSV and feather."""
    import pandas as pd

    rng = np.random.RandomState(11)
    n = 300
    df = pd.DataFrame({
        "true_energy": 10 ** rng.uniform(0.1, 1.9, n),
        "true_coszen": rng.uniform(-1, 1, n),
        "grad__opt_eff_overall": rng.uniform(0, 2, n),
        "grad__ice_scattering": rng.uniform(0, 2, n),
        "grad__opt_eff_overall__ice_scattering": rng.uniform(0, 2, n),
    })
    df.to_csv(path_csv, index=False)
    df.to_feather(path_feather)
    return df


@pytest.mark.parametrize("fmt", ["csv", "feather"])
def test_ultrasurfaces_matches_jax(tmp_path, fmt):
    from sklearn.neighbors import KDTree

    paths = {f: str(tmp_path / f"us.{f}") for f in ("csv", "feather")}
    df = _us_table(paths["csv"], paths["feather"])
    services = {}
    for package in ("jax", "torch"):
        module = importlib.import_module(
            f"{'pisa_tpu' if package == 'jax' else 'pisa_tpu_torch'}"
            ".stages.discr_sys.ultrasurfaces")
        params = module.init_test().params
        service = module.ultrasurfaces(
            params=params, fit_results_file=paths[fmt],
            varnames=["true_energy", "true_coszen"],
            nominal_points={"opt_eff_overall": 1.0, "ice_scattering": 0.0},
            calc_mode="events", event_grouping_key=None,
            support={"opt_eff_overall": (0.9, 1.05),
                     "ice_scattering": (-0.1, 0.1)},
            extrapolation="constant")
        ureg = jax_ureg if package == "jax" else torch_ureg
        service.params["opt_eff_overall"].value = 1.08 * ureg.dimensionless
        service.params["ice_scattering"].value = 0.05 * ureg.dimensionless
        service = _harness(package, "discr_sys", "ultrasurfaces",
                           service=service)
        service.setup()
        service.run()
        services[package] = service
    _assert_weights(_weights(services["jax"]), _weights(services["torch"]))
    tree = KDTree(df[["true_energy", "true_coszen"]].to_numpy())
    for c in services["torch"].data:
        x = np.stack([c["true_energy"].numpy(), c["true_coszen"].numpy()], 1)
        _, ind = tree.query(x, k=1)
        np.testing.assert_array_equal(
            services["torch"].matched_indices[c.name], ind.ravel())


def test_service_matrix_rows():
    """The four services run in the port's matrix (map mode: not a map
    service, as in the JAX package)."""
    for stage_name, service_name in (("discr_sys", "hypersurfaces"),
                                     ("discr_sys", "csv_hypersurfaces"),
                                     ("discr_sys", "ultrasurfaces"),
                                     ("background", "atm_muons")):
        assert (stage_name, service_name) in TSM.discover_services()
        for mode, status in (("events", "ok"), ("map", "n/a")):
            assert TSM.run_service(stage_name, service_name, mode,
                                   device="cpu") == status
