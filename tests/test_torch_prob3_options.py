"""
Every option of the port's prob3 (``pisa_tpu_torch/stages/osc/prob3.py``)
against the JAX package's, in fp64 on the CPU (conftest): NSI (standard and
vacuum-like), neutrino decay, the three LRI symmetries, the three Earth
tomography types, layer dedup, and the per-event calc mode, stacked and not.

The toy ``osc_example_coarse.cfg`` carries the options (as
tests/test_nsi_pipeline.py builds them); the flagship
``IceCube_3y_neutrinos.cfg`` runs the per-event calc mode at 1% of its
events and the float32 decay gradient on its 20x20-grid cut
(tests/test_torch_pipeline.py). Tolerances: eager maps 1e-9 relative per
bin, and 1e-12 of the map's largest bin for the near-empty ones (the two
packages differ in operation order, and on the CPU the port's NSI and LRI
forward is the primal kernel's plain version where the JAX package runs its
XLA formulation); compiled gradients at tests/test_rate_defer.py's
bounds (value rtol 5e-5, atol 1e-8; gradient rtol 5e-4, atol 2e-4).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.config.parser import parse_pipeline_config as jax_parse
from pisa_tpu.core.param import Param as JaxParam
from pisa_tpu.core.param import ParamSet as JaxParamSet
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu_torch import ureg as torch_ureg
from pisa_tpu_torch.config.parser import parse_pipeline_config as torch_parse
from pisa_tpu_torch.core.param import Param as TorchParam
from pisa_tpu_torch.core.param import ParamSet as TorchParamSet
from pisa_tpu_torch.core.pipeline import Pipeline as TorchPipeline
from pisa_tpu_torch.ops.osc.nonstandard import FIVE_LAYER_RADII_KM, FIVE_LAYER_RHOS
from pisa_tpu_torch.utils.resources import find_resource
from pisa_tpu_torch.utils.interop import (
    template_inputs_from_jax,
    to_template_order,
)

TOY = "settings/pipeline/osc_example_coarse.cfg"
FLAGSHIP = "settings/pipeline/IceCube_3y_neutrinos.cfg"
MAP_RTOL = 1e-9
MAP_ATOL_FRACTION = 1e-12  # of the map's largest bin: near-empty bins
VALUE = {"rtol": 5e-5, "atol": 1e-8}
GRAD = {"rtol": 5e-4, "atol": 2e-4}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# option -> (stage settings, {param: (value, unit, free, (lo, hi))}, the
# param moved for the second point and its value there)
_EPS_STD = {"eps_ee": 0.2, "eps_emu_magn": 0.05, "eps_emu_phase": 0.3,
            "eps_etau_magn": 0.07, "eps_etau_phase": -1.1, "eps_mumu": -0.1,
            "eps_mutau_magn": 0.12, "eps_mutau_phase": 2.0,
            "eps_tautau": 0.15}
_EPS_VAC = {"eps_scale": 1.3, "eps_prime": 0.4, "phi12": 0.3, "phi13": -0.2,
            "phi23": 0.9, "alpha1": 0.5, "alpha2": -0.7, "deltansi": 1.9}
_ANGLES = {"eps_emu_phase", "eps_etau_phase", "eps_mutau_phase", "phi12",
           "phi13", "phi23", "alpha1", "alpha2", "deltansi"}


def _couplings(values, free=()):
    return {n: (v, "rad" if n in _ANGLES else "dimensionless", n in free,
                (-2.0, 2.0)) for n, v in values.items()}


OPTIONS = {
    "nsi-standard": ({"nsi_type": "standard"}, _couplings(_EPS_STD),
                     ("eps_mutau_magn", 0.2)),
    "nsi-vacuum-like": ({"nsi_type": "vacuum-like"}, _couplings(_EPS_VAC),
                        ("eps_scale", 0.8)),
    "decay": ({"neutrino_decay": True},
              {"decay_alpha3": (1e-4, "eV**2", False, (0.0, 1e-3))},
              ("decay_alpha3", 3e-4)),
    "lri-emu": ({"lri_type": "emu-symmetry"},
                {"v_lri": (5e-14, "eV", False, (0.0, 1e-13))},
                ("v_lri", 2e-14)),
    "lri-etau": ({"lri_type": "etau-symmetry"},
                 {"v_lri": (5e-14, "eV", False, (0.0, 1e-13))},
                 ("v_lri", 2e-14)),
    "lri-mutau": ({"lri_type": "mutau-symmetry"},
                  {"v_lri": (5e-14, "eV", False, (0.0, 1e-13))},
                  ("v_lri", 2e-14)),
    "tomography-earth": ({"tomography_type": "mass_of_earth"},
                         {"density_scale": (1.05, "dimensionless", False,
                                            (0.5, 1.5))},
                         ("density_scale", 0.9)),
    "tomography-core": ({"tomography_type": "mass_of_core_w_constrain"},
                        {"core_density_scale": (1.03, "dimensionless", False,
                                                (0.5, 1.5))},
                        ("core_density_scale", 0.98)),
    "tomography-core-free": (
        {"tomography_type": "mass_of_core_wo_constrain"},
        {"core_density_scale": (1.1, "dimensionless", False, (0.5, 1.5)),
         "innermantle_density_scale": (0.95, "dimensionless", False,
                                       (0.5, 1.5)),
         "middlemantle_density_scale": (1.02, "dimensionless", False,
                                        (0.5, 1.5))},
        ("innermantle_density_scale", 1.05)),
    "dedup": ({"layer_dedup": True}, {}, ("theta23", 45.0)),
}
# the coupling each option can free (tomography scales steer host-side
# work and stay fixed; dedup has none)
COUPLING = {"nsi-standard": "eps_mutau_magn", "nsi-vacuum-like": "eps_scale",
            "decay": "decay_alpha3", "lri-emu": "v_lri", "lri-etau": "v_lri",
            "lri-mutau": "v_lri"}
# the compiled gradients: the option and its free coupling
GRADIENTS = {o: COUPLING[o] for o in ("nsi-standard", "decay", "lri-mutau")}


@pytest.fixture(scope="module")
def five_layer_model(tmp_path_factory):
    """The 5-layer Earth model the core tomography types require."""
    path = tmp_path_factory.mktemp("earth") / "PREM_5layer.dat"
    np.savetxt(path, np.stack([FIVE_LAYER_RADII_KM, FIVE_LAYER_RHOS], axis=1))
    return str(path)


@pytest.fixture(scope="module")
def tiny_toy(tmp_path_factory):
    """The toy config with its grids cut to tiny_grid (8x8): the forward-mode
    and lanes tests' size."""
    src = open(find_resource(TOY)).read()
    path = tmp_path_factory.mktemp("options") / "osc_tiny.cfg"
    path.write_text(src.replace("calc_grid_coarse", "tiny_grid"))
    return str(path)


def _toy(option, package, earth_model=None, free=None, path=TOY):
    """The toy config (or the one at `path`) with `option`'s settings and
    params for `package` ("jax" or "torch"), `free` the one coupling left
    free."""
    parse, Param, ParamSet, ureg = {
        "jax": (jax_parse, JaxParam, JaxParamSet, jax_ureg),
        "torch": (torch_parse, TorchParam, TorchParamSet, torch_ureg),
    }[package]
    settings, params, _ = OPTIONS[option]
    config = parse(path)
    section = config[("osc", "prob3")]
    section.update(settings)
    units = {"rad": ureg.rad, "dimensionless": ureg.dimensionless,
             "eV": ureg.eV, "eV**2": ureg.eV ** 2}
    extra = [
        Param(name=n, value=v * units[u], is_fixed=n != free,
              range=(lo, hi) * units[u])
        for n, (v, u, _, (lo, hi)) in params.items()
    ]
    if option.startswith("tomography-core"):
        extra.append(Param(name="earth_model", value=earth_model,
                           is_fixed=True))
    section["params"].update(ParamSet(extra))
    return config


def _assert_maps_close(want, got):
    assert [m.name for m in want] == [m.name for m in got]
    for m in want:
        want_hist = np.asarray(m.hist)
        np.testing.assert_allclose(
            got[m.name].hist, want_hist, rtol=MAP_RTOL,
            atol=MAP_ATOL_FRACTION * np.abs(want_hist).max(), err_msg=m.name)


def _set(pipeline, name, value, ureg):
    prm = pipeline.params[name]
    prm.value = value * (ureg.degree if name == "theta23" else prm.units)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_outputs_match_jax(option, five_layer_model):
    """get_outputs at the option's values and after one of them moves
    (re-deriving the layers, for tomography)."""
    jax_p = JaxPipeline(_toy(option, "jax", five_layer_model))
    torch_p = TorchPipeline(_toy(option, "torch", five_layer_model),
                            device="cpu")
    _assert_maps_close(jax_p.get_outputs(), torch_p.get_outputs())
    name, value = OPTIONS[option][2]
    _set(jax_p, name, value, jax_ureg)
    _set(torch_p, name, value, torch_ureg)
    _assert_maps_close(jax_p.get_outputs(), torch_p.get_outputs())


def test_tomography_needs_the_five_layer_model():
    with pytest.raises(ValueError, match="5-layer Earth model"):
        TorchPipeline(_toy("tomography-core", "torch",
                           "osc/PREM_12layer.dat"), device="cpu")


def test_invalid_option_values_raise():
    for key, value in (("nsi_type", "bogus"), ("lri_type", "bogus"),
                       ("tomography_type", "bogus")):
        config = torch_parse(TOY)
        config[("osc", "prob3")][key] = value
        with pytest.raises(ValueError, match="invalid"):
            TorchPipeline(config, device="cpu")


@pytest.mark.parametrize("option", list(GRADIENTS))
def test_compiled_gradient_in_the_coupling_matches_jax(option):
    """The compiled template's mod_chi2 value and gradient, with the
    option's coupling free beside theta23 and delta_index, off the Asimov
    point (test_nsi_pipeline.py's point: +0.07 rescaled, clipped)."""
    free = GRADIENTS[option]
    jax_ct = JaxPipeline(_toy(option, "jax", free=free)).compile()
    ct = TorchPipeline(_toy(option, "torch", free=free), device="cpu").compile()
    assert free in ct.free_names
    data = jax_ct.get_outputs()
    _, jax_vg = jax_ct.build_objective(data, "mod_chi2")
    _, vg = ct.build_objective({m.name: np.asarray(m.hist) for m in data},
                               "mod_chi2")
    v = np.clip(np.asarray(jax_ct.current_rescaled_values()) + 0.07, 0.05,
                0.95)
    want_v, want_g = jax_vg(v)
    vec, _, _ = template_inputs_from_jax(ct, jax_ct.free_names, v,
                                         *jax_ct._current_bounds())
    got_v, got_g = vg(vec)
    np.testing.assert_allclose(float(got_v), float(want_v), **VALUE)
    want_g = to_template_order(ct, jax_ct.free_names, np.asarray(want_g))
    assert want_g[ct.free_names.index(free)] != 0.0
    np.testing.assert_allclose(got_g.numpy(), want_g, **GRAD)


def test_lanes_under_options_raise():
    """Lanes under NSI no longer raise: prob3's compute with
    ``container.lanes`` = 2 (the general route, (2, 3, 3) physics inputs)
    gives each lane the probabilities of its own single point, here the
    pipeline's values in lane 0 and eps_mutau_magn moved in lane 1 (1e-12
    relative)."""
    p = TorchPipeline(_toy("nsi-standard", "torch"), device="cpu")
    p.get_outputs()
    stage = p["osc.prob3"]
    prm = p.params["eps_mutau_magn"]
    nominal = prm.value
    singles = []
    for value in (nominal.m, 0.2):
        prm.value = value * torch_ureg.dimensionless
        stage.compute_function()
        singles.append({c.name: c["probability"].clone() for c in p.data})
    lanes = torch.tensor([[nominal.m], [0.2]], dtype=torch.float64)
    prm._value = torch_ureg.Quantity(lanes, "dimensionless")
    p.data.lanes = 2
    try:
        stage.compute_function()
        got = {c.name: c["probability"].clone() for c in p.data}
    finally:
        p.data.lanes = None
        prm.value = nominal
    for name, probs in got.items():
        assert probs.shape[0] == 2
        for b in range(2):
            np.testing.assert_allclose(probs[b].numpy(),
                                       singles[b][name].numpy(), rtol=1e-12,
                                       atol=1e-15, err_msg=name)


# -- the per-event calc mode ------------------------------------------------------
def _events_config(parse):
    config = parse(FLAGSHIP)
    config[("data", "csv_loader")]["fraction_events_to_keep"] = 0.01
    for key in (("flux", "barr_simple"), ("osc", "prob3")):
        config[key]["calc_mode"] = "events"
    return config


@pytest.fixture(scope="module")
def events():
    """(JAX template, port pipeline, stacked and per-container port
    templates) of the flagship at calc_mode = events, 1% of its events."""
    jax_ct = JaxPipeline(_events_config(jax_parse)).compile()
    pipeline = TorchPipeline(_events_config(torch_parse), device="cpu")
    stacked = pipeline.compile()
    unstacked = pipeline.compile(stack=False)
    return jax_ct, pipeline, stacked, unstacked


def _events_point(jax_ct):
    v0 = np.clip(np.asarray(jax_ct.current_rescaled_values()), 0.15, 0.85)
    rng = np.random.RandomState(5)
    return np.clip(v0 + rng.uniform(-0.1, 0.1, v0.size), 0.15, 0.85)


def test_events_mode_eager_matches_jax(events):
    jax_ct, pipeline, _, _ = events
    _assert_maps_close(jax_ct.pipeline.get_outputs(), pipeline.get_outputs())


def test_events_mode_stacked_matches_per_container(events):
    """The stacked template (prob3 and barr_simple stacked in the per-event
    mode: one propagation per nubar group) against the per-container one
    and the JAX template, off nominal."""
    jax_ct, _, stacked, unstacked = events
    assert stacked.stacked and not unstacked.stacked
    v = _events_point(jax_ct)
    vec = to_template_order(stacked, jax_ct.free_names, v)
    want = stacked.get_outputs(vec)
    _assert_maps_close(jax_ct.get_outputs(v), want)
    got = unstacked.get_outputs(vec)
    for m in want:
        np.testing.assert_allclose(got[m.name].hist, m.hist, rtol=1e-12,
                                   atol=0, err_msg=m.name)


def test_events_mode_gradient_matches_jax(events):
    jax_ct, _, stacked, _ = events
    data = jax_ct.get_outputs(jax_ct.current_rescaled_values())
    _, jax_vg = jax_ct.build_objective(data, "mod_chi2")
    _, vg = stacked.build_objective({m.name: np.asarray(m.hist) for m in data},
                                    "mod_chi2")
    v = _events_point(jax_ct)
    want_v, want_g = jax_vg(v)
    vec, _, _ = template_inputs_from_jax(stacked, jax_ct.free_names, v,
                                         *jax_ct._current_bounds())
    got_v, got_g = vg(vec)
    np.testing.assert_allclose(float(got_v), float(want_v), rtol=1e-9)
    want_g = to_template_order(stacked, jax_ct.free_names, np.asarray(want_g))
    scale = np.abs(want_g).max()
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-7,
                               atol=1e-9 * scale)


def _lanes_match_single_points(ct):
    """mod_chi2's batched value and gradient at 3 seeded points (lanes)
    against each point's own, 1e-12 relative (the gradient: of its
    largest)."""
    v0 = ct.current_rescaled_values()
    value_fn, _ = ct.build_objective(ct.get_outputs(v0), "mod_chi2")
    los, his = ct._device_bounds()
    x = np.clip(v0 + np.random.RandomState(8).uniform(-0.1, 0.1,
                                                      (3, v0.size)),
                0.05, 0.95)
    vec = torch.tensor(x, requires_grad=True)
    values = value_fn.raw_with_data(vec, los, his, None)
    assert values.shape == (3,)
    values.sum().backward()
    for b in range(3):
        xb = torch.tensor(x[b], requires_grad=True)
        value = value_fn.raw(xb, los, his)
        value.backward()
        np.testing.assert_allclose(float(values[b].detach()),
                                   float(value.detach()), rtol=1e-12)
        scale = float(xb.grad.abs().max())
        assert scale > 0
        assert float((vec.grad[b] - xb.grad).abs().max()) <= 1e-12 * scale


def test_events_mode_lanes_match_single_points(events):
    """The stacked per-event template's batched objective: its groups'
    blocks and barr_simple's per-event flux carry the lane axis."""
    _, _, stacked, _ = events
    _lanes_match_single_points(stacked)


@pytest.mark.parametrize("dedup", [False, True], ids=["standard", "dedup"])
def test_events_mode_pads_unequal_categories(monkeypatch, dedup):
    """Categories of unequal size (one cut to 150 of its 200 events): the
    stacked per-event mode pads them, the padded events' inputs sanitized
    to chains with no layer step; its maps equal the per-container
    template's (1e-12), and its gradient theirs (1e-9), every entry
    finite. On the standard route (the kernels' plain versions here) and
    on the dedup route, whose transitions are built for every slot, padded
    ones included."""
    from pisa_tpu_torch.stages.data.csv_loader import csv_loader

    setup = csv_loader.setup_function

    def setup_unequal(self):
        setup(self)
        container = self.data["nutau_nc"]
        for key in container.keys:
            container[key] = container[key][:150]

    monkeypatch.setattr(csv_loader, "setup_function", setup_unequal)
    config = _events_config(torch_parse)
    config[("osc", "prob3")]["layer_dedup"] = dedup
    pipeline = TorchPipeline(config, device="cpu")
    stacked = pipeline.compile()
    unstacked = pipeline.compile(stack=False)
    assert stacked.stacked and not unstacked.stacked
    prob3 = pipeline.stages[[type(s).__name__ for s in pipeline.stages]
                            .index("prob3")]
    static = prob3._stacked_events_geometry(
        stacked._trace_data.containers[0])
    assert sum(int((g["dist"] > 0).sum(dim=-1 if dedup else 0).eq(0).sum())
               for _, g in static["groups"]) == 50

    v0 = unstacked.current_rescaled_values()
    data = {m.name: np.asarray(m.hist) for m in unstacked.get_outputs(v0)}
    vec = np.clip(v0 + np.random.RandomState(5).uniform(-0.1, 0.1, v0.size),
                  0.15, 0.85)
    want = unstacked.get_outputs(vec)
    for m in stacked.get_outputs(vec):
        np.testing.assert_allclose(m.hist, want[m.name].hist, rtol=1e-12,
                                   atol=0, err_msg=m.name)
    (want_v, want_g), (got_v, got_g) = (
        ct.build_objective(data, "mod_chi2")[1](vec)
        for ct in (unstacked, stacked))
    assert np.all(np.isfinite(got_g.numpy()))
    np.testing.assert_allclose(float(got_v), float(want_v), rtol=1e-12)
    np.testing.assert_allclose(got_g.numpy(), want_g.numpy(), rtol=1e-9,
                               atol=1e-12 * float(want_g.abs().max()))


# -- the float32 decay gradient -------------------------------------------------------
# mod_chi2's value and gradient on the 20x20-grid flagship at 5% of its
# events with neutrino decay, decay_alpha3 free (nominal 0), against Asimov
# data at nominal: at nominal and at +0.05 rescaled, in the float type of the
# process that runs it (the port only)
_DECAY_CODE = """
import sys
sys.path[:0] = [{root!r}, {tests!r}]
import numpy as np
from pisa_tpu_torch import ureg
from pisa_tpu_torch.config.parser import parse_pipeline_config
from pisa_tpu_torch.core import binning
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.pipeline import Pipeline
from test_torch_pipeline import _small_grid_config


def decay_gradients():
    config = _small_grid_config(parse_pipeline_config, binning, ureg)
    config[("data", "csv_loader")]["fraction_events_to_keep"] = 0.05
    section = config[("osc", "prob3")]
    section["neutrino_decay"] = True
    section["params"].update(ParamSet([Param(
        name="decay_alpha3", value=0.0 * ureg.eV ** 2,
        range=(0.0, 1e-3) * ureg.eV ** 2, is_fixed=False)]))
    ct = Pipeline(config, device="cpu").compile()
    _, vg = ct.build_objective({{m.name: m.hist for m in ct.get_outputs()}},
                               "mod_chi2")
    v0 = ct.current_rescaled_values()
    out = {{"names": ct.free_names}}
    for label, v in (("nominal", v0), ("moved", np.clip(v0 + 0.05, 0, 1))):
        value, grad = vg(v)
        out[label] = [float(value), grad.double().tolist()]
    return out
""".format(root=ROOT, tests=os.path.join(ROOT, "tests"))


def test_float32_decay_gradient_is_finite():
    """The JAX package's float32 gradient of this objective is NaN in
    theta13, theta23, deltam31 and decay_alpha3 (its Cardano square root's
    derivative at a negative real discriminant); the port's is finite in
    every entry at nominal and off it, and off it agrees with the float64
    gradient (float32 rounding of the objective: rtol 1e-3, atol 1e-4 of
    the largest entry)."""
    script = _DECAY_CODE + "\nimport json\nprint(json.dumps(decay_gradients()))\n"
    env = dict(os.environ, PISA_TPU_FTYPE="fp32")
    run = subprocess.run([sys.executable, "-c", script], env=env, check=True,
                         capture_output=True, text=True, cwd=ROOT)
    fp32 = json.loads(run.stdout.strip().splitlines()[-1])
    namespace = {}
    exec(_DECAY_CODE, namespace)
    fp64 = namespace["decay_gradients"]()
    assert fp32["names"] == fp64["names"]
    for label in ("nominal", "moved"):
        assert np.all(np.isfinite(fp32[label][1])), label
    value32, grad32 = fp32["moved"]
    value64, grad64 = fp64["moved"]
    np.testing.assert_allclose(value32, value64, rtol=1e-4)
    grad64 = np.asarray(grad64)
    np.testing.assert_allclose(grad32, grad64, rtol=1e-3,
                               atol=1e-4 * np.abs(grad64).max())


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("option", ["nsi-vacuum-like", "decay", "lri-emu",
                                    "dedup"])
def test_option_outputs_on_card(option, cuda_device):
    """get_outputs on the card against the CPU, float64 (1e-9 relative)."""
    maps = [TorchPipeline(_toy(option, "torch"), device=device).get_outputs()
            for device in ("cpu", cuda_device)]
    _assert_maps_close(*maps)
