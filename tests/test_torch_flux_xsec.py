"""
The port's flux, cross-section and absorption services (``flux.mceq_barr``,
``flux.mceq_barr_red``, ``flux.hillasg``, ``flux.astrophysical``,
``xsec.nutau_xsec``, ``xsec.dis_sys``, ``xsec.genie_sys``,
``xsec.correct_charm_y``, ``absorption.earth_absorption``) against the JAX
package's, in fp64 on the CPU (conftest): each service through both
packages' service-matrix harnesses on the same synthetic containers, in
events mode and in map mode where the JAX package supports it, with its
parameters moved off their nominal values; each parameter gradient against
the JAX package's ``jax.grad`` on the same containers; and the MCEq-Barr
flagship (``testing/mceq_flagship.py``) on a 20x20 grid at 5% of the
events: its maps and its compiled ``mod_chi2`` value and gradient.

Tolerances: outputs 1e-10 relative (the same arithmetic, in another
order); gradients 1e-9 relative of the largest entry; maps 1e-9 of each
map's largest bin; the compiled value 1e-9 and each gradient entry 1e-8
relative (tighter than ``tests/test_rate_defer.py``'s); a template against
the same package's eager run 1e-12.
"""

import importlib
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.config.parser import parse_pipeline_config as jax_parse
from pisa_tpu.core import binning as jax_binning
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu.testing import service_matrix as JSM
from pisa_tpu_torch import ureg as torch_ureg
from pisa_tpu_torch.core.pipeline import Pipeline as TorchPipeline
from pisa_tpu_torch.testing import service_matrix as TSM
from pisa_tpu_torch.testing.mceq_flagship import mceq_flagship_config
from pisa_tpu_torch.utils.interop import (
    template_inputs_from_jax,
    to_template_order,
)

OUT_RTOL = 1e-10
GRAD_RTOL = 1e-9
MAP_TOL = 1e-9
VALUE_RTOL = 1e-9
VG_RTOL = 1e-8
SELF_RTOL = 1e-12
SEED = 42

#: service -> (stage package, the keys it writes that are compared, the
#: parameter values it is run at)
SERVICES = {
    "mceq_barr": ("flux", ("nu_flux",), {
        "barr_a_Pi": 0.1, "barr_e_Pi": -0.04, "barr_h_Pi": 0.12,
        "barr_w_K": 0.3, "barr_y_antiK": -0.2, "pion_ratio": 0.05,
        "delta_index": 0.08}),
    "mceq_barr_red": ("flux", ("nu_flux",), {
        "barr_af_Pi": 0.1, "barr_g_Pi": -0.2, "barr_x_K": 0.05,
        "barr_z_antiK": -0.1, "pion_ratio": -0.03, "delta_index": -0.06}),
    "hillasg": ("flux", ("nu_flux_nominal", "nubar_flux_nominal"), {}),
    "astrophysical": ("flux", ("astro_flux", "astro_weights"), {
        "astro_norm": 1.3, "astro_delta": 0.2}),
    "nutau_xsec": ("xsec", ("weights",), {"nutau_xsec_scale": 0.7}),
    "dis_sys": ("xsec", ("weights",), {"dis_csms": 0.6}),
    "genie_sys": ("xsec", ("weights",), {"Genie_Ma_QE": -0.4,
                                         "Genie_Ma_RES": 0.7}),
    "correct_charm_y": ("xsec", ("weights",), {}),
    "earth_absorption": ("absorption", ("weights",), {}),
}

CASES = [(s, "events") for s in SERVICES] + [
    (s, "map") for s in SERVICES
    if (SERVICES[s][0], s) in JSM.MAP_MODE_SERVICES]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _host(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) \
        else x.detach().numpy()


def _service(package, name, mode, energies=None):
    """The service of `name`'s init_test from `package` at its test values,
    with the harness's synthetic data (the same for both packages) and set
    up; `energies` (optional) replaces every container's true energies."""
    stage, _, values = SERVICES[name]
    harness, ureg, kw = ((JSM, jax_ureg, {}) if package == "pisa_tpu"
                         else (TSM, torch_ureg, {"device": "cpu"}))
    service = importlib.import_module(
        f"{package}.stages.{stage}.{name}").init_test()
    for pname, value in values.items():
        p = service.params[pname]
        p.value = value * p.units
    rng = np.random.RandomState(SEED)
    if mode == "map":
        service.calc_mode = harness.TEST_BINNING
        service.data = harness.make_map_data(service, rng, **kw)
    else:
        service.data = harness.make_events_data(service, rng, **kw)
    if energies is not None:
        for c in service.data:
            c["true_energy"] = energies[:c.size]
    service.setup()
    return service


def _outputs(package, name, mode):
    service = _service(package, name, mode)
    service.run()
    keys = SERVICES[name][1]
    return {(c.name, k): _host(c[k]) for c in service.data for k in keys}


@pytest.mark.parametrize("name,mode", CASES)
def test_service_matches_jax(name, mode):
    want = _outputs("pisa_tpu", name, mode)
    got = _outputs("pisa_tpu_torch", name, mode)
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        assert np.all(np.isfinite(got[key])), key
        np.testing.assert_allclose(got[key], ref, rtol=OUT_RTOL, atol=0,
                                   err_msg=str(key))
    if SERVICES[name][2] or name == "correct_charm_y":
        # the service changes something
        assert any(not np.allclose(got[k], 1.0) for k in got)


def test_new_services_report_ok_in_the_matrix():
    """The port's service matrix (events and map mode) reports each new
    service as ok, or n/a where it has no map mode."""
    for name, (stage, _, _) in SERVICES.items():
        assert TSM.run_service(stage, name, "events", device="cpu") == "ok"
        want = "ok" if (stage, name) in TSM.MAP_MODE_SERVICES else "n/a"
        assert TSM.run_service(stage, name, "map", device="cpu") == want


def _loss_weights(service):
    rng = np.random.RandomState(7)
    return {(c.name, k): rng.uniform(0.5, 1.5, tuple(c[k].shape))
            for c in service.data for k in SERVICES[service.service_name][1]}


def _jax_grad(name, mode, names, energies):
    service = _service("pisa_tpu", name, mode, energies)
    service._trace_mode = True
    rw = None

    def loss(v):
        nonlocal rw
        for pname, x in zip(names, v):
            p = service.params[pname]
            p._value = jax_ureg.Quantity(x, p.units)
        service.run()
        if rw is None:
            rw = _loss_weights(service)
        return sum(jnp.sum(c[k] * rw[(c.name, k)]) for c in service.data
                   for k in SERVICES[name][1])

    v0 = jnp.asarray([SERVICES[name][2][n] for n in names])
    return np.asarray(jax.grad(loss)(v0))


def _torch_grad(name, mode, names, energies):
    service = _service("pisa_tpu_torch", name, mode, energies)
    service._template_mode = True
    v = torch.tensor([SERVICES[name][2][n] for n in names],
                     dtype=torch.float64, requires_grad=True)
    for pname, x in zip(names, v.unbind()):
        p = service.params[pname]
        p._value = torch_ureg.Quantity(x, p.units)
    service.run()
    rw = _loss_weights(service)
    loss = sum((c[k] * torch.as_tensor(rw[(c.name, k)])).sum()
               for c in service.data for k in SERVICES[name][1])
    (g,) = torch.autograd.grad(loss, v)
    return g.numpy()


@pytest.mark.parametrize("name,mode", [
    (s, m) for s, m in CASES if SERVICES[s][2]])
def test_parameter_gradients_match_jax(name, mode):
    """d(sum of the outputs x fixed random weights)/d(each parameter) at
    the test values: the port's autograd against ``jax.grad``. nutau_xsec
    runs on energies above the tau threshold here, where the JAX package's
    gradient is defined (see the next test)."""
    names = sorted(SERVICES[name][2])
    energies = None
    if name == "nutau_xsec":
        energies = 10 ** np.random.RandomState(3).uniform(0.6, 1.9, 40)
    want = _jax_grad(name, mode, names, energies)
    got = _torch_grad(name, mode, names, energies)
    assert np.all(np.isfinite(want)) and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_RTOL * np.abs(want).max())


def test_nutau_scale_below_threshold_is_zero_with_a_finite_gradient():
    """Below the tau threshold (the harness's energies reach 1.26 GeV) the
    JAX package's gradient in nutau_xsec_scale is NaN (0 x -inf in its
    clip) and its scale is NaN at nutau_xsec_scale = 0; the port's scale
    is 0 there at every value and its gradient finite. Above the threshold
    the two agree (test_parameter_gradients_match_jax)."""
    names = ["nutau_xsec_scale"]
    assert np.isnan(_jax_grad("nutau_xsec", "events", names, None)).all()
    got = _torch_grad("nutau_xsec", "events", names, None)
    assert np.isfinite(got).all() and got[0] != 0
    service = _service("pisa_tpu_torch", "nutau_xsec", "events")
    service.params["nutau_xsec_scale"].value = 0.0 * torch_ureg.dimensionless
    service.run()
    c = service.data["nutau_cc"]
    below = c["nutau_below_threshold"]
    assert below.any() and (~below).any()
    assert (c["nutau_xsec_scale"][below] == 0).all()
    assert (c["nutau_xsec_scale"][~below] == 1).all()


def _apart(jax_pipeline):
    """The JAX pipeline with its earth_absorption's Earth-layer chains kept
    apart from its prob3's. The JAX package's two stages share the
    container keys 'densities' and 'distances': absorption's set-up
    overwrites prob3's electron densities with total densities, which prob3
    then reads at every compute. The JAX stages run unchanged; prob3's set
    is restored after the set-up, and absorption's is swapped in around its
    compute only."""
    (absorption,) = [s for s in jax_pipeline.stages
                     if s.service_name == "earth_absorption"]
    (prob3,) = [s for s in jax_pipeline.stages if s.service_name == "prob3"]
    keys = ("densities", "distances")
    assert absorption.calc_mode == prob3.calc_mode
    absorption.data.representation = absorption.calc_mode
    mine = {(c.name, k): c[k] for c in absorption.data for k in keys}
    prob3.setup()
    prob3.data.representation = prob3.calc_mode
    theirs = {(c.name, k): c[k] for c in prob3.data for k in keys}
    compute = absorption.compute_function

    def compute_apart():
        for c in absorption.data:
            for k in keys:
                c[k] = mine[(c.name, k)]
        compute()
        for c in absorption.data:
            for k in keys:
                c[k] = theirs[(c.name, k)]

    absorption.compute_function = compute_apart
    return jax_pipeline


def test_jax_absorption_overwrites_prob3_layers():
    """The JAX package's fault that _apart works around: with
    earth_absorption in the pipeline its prob3 oscillates with the total
    matter density (the maps move by far more than the absorption), the
    port's does not (the maps move by the survival probability alone)."""
    with tempfile.TemporaryDirectory() as d:
        cfg = mceq_flagship_config(d, 20, 0.05, parse=jax_parse,
                                   binning=jax_binning, ureg=jax_ureg)
    clash = JaxPipeline(cfg).get_outputs()
    apart = _apart(JaxPipeline(cfg)).get_outputs()
    rel = max(np.abs(np.asarray(clash[m.name].hist) - np.asarray(m.hist))
              .max() / np.asarray(m.hist).max() for m in apart)
    assert rel > 1e-3


def test_mceq_flagship_matches_jax():
    """The MCEq-Barr flagship on a 20x20 grid at 5% of the events: the
    port's eager maps against the JAX package's; the port's compiled
    template (per container, 31 free) against its eager run; its mod_chi2
    value and gradient at a moved point against the JAX CompiledTemplate's,
    the port's eager maps the data of both; the JAX pipeline's absorption
    and prob3 kept apart (_apart)."""
    with tempfile.TemporaryDirectory() as d:
        cfg = mceq_flagship_config(d, 20, 0.05)
        jax_cfg = mceq_flagship_config(d, 20, 0.05, parse=jax_parse,
                                       binning=jax_binning, ureg=jax_ureg)
    pipeline = TorchPipeline(cfg, device="cpu")
    got = pipeline.get_outputs()
    jax_pipeline = _apart(JaxPipeline(jax_cfg))
    want = jax_pipeline.get_outputs()
    assert [m.name for m in got] == [m.name for m in want]
    for m in want:
        ref = np.asarray(m.hist)
        assert np.all(np.isfinite(got[m.name].hist))
        np.testing.assert_allclose(got[m.name].hist, ref, rtol=0,
                                   atol=MAP_TOL * np.abs(ref).max(),
                                   err_msg=m.name)

    ct = pipeline.compile()
    assert not ct.stacked and len(ct.free_names) == 31
    hist = ct.get_outputs()
    for m in got:
        np.testing.assert_allclose(hist[m.name].hist, m.hist,
                                   rtol=SELF_RTOL, atol=0, err_msg=m.name)

    data = {m.name: m.hist for m in got}
    jax_ct = jax_pipeline.compile()
    _, jax_vg = jax_ct.build_objective(data, "mod_chi2")
    v0 = np.asarray(jax_ct.current_rescaled_values())
    v = np.clip(v0 + np.random.RandomState(5).uniform(-0.05, 0.05, v0.size),
                0.02, 0.98)
    want_value, want_grad = jax_vg(jnp.asarray(v))
    assert sorted(ct.free_names) == sorted(jax_ct.free_names)
    want_grad = to_template_order(ct, jax_ct.free_names,
                                  np.asarray(want_grad))
    vec, _, _ = template_inputs_from_jax(
        ct, jax_ct.free_names, v,
        *[np.asarray(b) for b in jax_ct._current_bounds()])
    value_fn, vg = ct.build_objective(data, "mod_chi2")
    value, grad = vg(vec)
    assert abs(float(value) - float(want_value)) <= VALUE_RTOL * abs(
        float(want_value))
    grad = grad.numpy()
    assert np.all(np.isfinite(grad))
    # the JAX package's gradient in nutau_xsec_scale is NaN (events below
    # the tau threshold, test_nutau_scale_below_threshold_is_zero_with_a_
    # finite_gradient); the port's is held against central differences
    tau = ct.free_names.index("nutau_xsec_scale")
    assert np.isnan(want_grad[tau])
    rest = [i for i in range(grad.size) if i != tau]
    assert np.all(np.isfinite(want_grad[rest]))
    np.testing.assert_allclose(grad[rest], want_grad[rest], rtol=VG_RTOL,
                               atol=0)
    h = 1e-6
    up, down = np.array(vec, dtype=np.float64), np.array(vec,
                                                         dtype=np.float64)
    up[tau] += h
    down[tau] -= h
    fd = (float(value_fn(up)) - float(value_fn(down))) / (2 * h)
    np.testing.assert_allclose(grad[tau], fd, rtol=1e-5)
