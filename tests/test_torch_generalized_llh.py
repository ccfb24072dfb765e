"""
The generalized Poisson-gamma likelihood's pipeline in the port
(``settings/pipeline/toy_generalized_llh.cfg``: toy events, aeff,
``utils.add_indices``, ``likelihood.generalized_llh_params``) against the
JAX package's, in fp64 on the CPU (conftest): the eager outputs, the
compiled template's histograms and ``llh_alphas``, ``llh_betas`` and
``n_mc_events``, and its objective under ``generalized_poisson_llh`` (per
map and with ``sum_maps``).

The same pipeline cut to its first two stages (whose binned weights the
JAX package's ``CompiledDistribution`` can sum; it cannot translate the
generalized stage's binned weights back to events) carries the
MC-uncertainty likelihoods through ``CompiledDistribution`` (with a nonzero
data variance: the JAX package passes the data's variance to these
metrics, and at zero they fall to their Poisson limit), through
``CompiledDetectors`` (two detectors, the variance from the data maps'
errors) and through ``Map.metric_per_map``. Objectives within 1e-9 (value)
and 1e-7 of the largest entry (gradient), at points away from the data's,
where the gradient is not round-off.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pisa_tpu.analysis.gradient import CompiledDetectors as JaxCompiledDet
from pisa_tpu.analysis.gradient import CompiledDistribution as JaxCompiled
from pisa_tpu.core.detectors import Detectors as JaxDetectors
from pisa_tpu.core.map import Map as JaxMap, MapSet as JaxMapSet
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu_torch.analysis.gradient import CompiledDetectors
from pisa_tpu_torch.analysis.gradient import CompiledDistribution
from pisa_tpu_torch.core.detectors import Detectors
from pisa_tpu_torch.core.map import Map, MapSet
from pisa_tpu_torch.core.pipeline import Pipeline
from pisa_tpu_torch.utils.resources import find_resource

CFG = "settings/pipeline/toy_generalized_llh.cfg"
LLH_KEYS = ("llh_alphas", "llh_betas", "n_mc_events")
MC_METRICS = ["mcllh_mean", "mcllh_eff", "barlow_llh", "conv_llh"]
VALUE_RTOL = 1e-9
GRAD_ATOL_FRACTION = 1e-7


@pytest.fixture(scope="module")
def pipelines():
    """(JAX eager outputs, JAX template, port pipeline, port template,
    port eager outputs), the eager outputs taken before compiling (the JAX
    package's template fails after an eager run of this pipeline)."""
    jax_p = JaxPipeline(CFG)
    jax_eager = jax_p.get_outputs()
    p = Pipeline(CFG, device="cpu")
    eager = p.get_outputs()
    return jax_eager, jax_p.compile(), p, p.compile(), eager


def _points(ct):
    v0 = ct.current_rescaled_values()
    return {"up": np.clip(v0 + 0.07, 0.0, 1.0),
            "down": np.clip(v0 - 0.05, 0.0, 1.0)}


@pytest.fixture(scope="module")
def two_stage_cfgs(tmp_path_factory):
    """The config cut to toy events and aeff, as one pipeline and as two
    detectors (seeds 3 and 4)."""
    tmp = tmp_path_factory.mktemp("gencfg")
    text = open(find_resource(CFG)).read().replace(
        "order = data.toy_event_generator, aeff.aeff, utils.add_indices,"
        " likelihood.generalized_llh_params",
        "order = data.toy_event_generator, aeff.aeff")
    paths = {}
    for det, seed in (("single", 3), ("detA", 3), ("detB", 4)):
        body = text.replace("param.seed = 3", f"param.seed = {seed}")
        if det != "single":
            body = body.replace("name = neutrinos",
                                f"name = neutrinos\ndetector_name = {det}")
        paths[det] = tmp / f"{det}.cfg"
        paths[det].write_text(body)
    return {k: str(v) for k, v in paths.items()}


def _check_objective(got, want):
    value, grad = (np.asarray(x) for x in got)
    want_value, want_grad = (np.asarray(x) for x in want)
    np.testing.assert_allclose(value, want_value, rtol=VALUE_RTOL, atol=0)
    np.testing.assert_allclose(
        grad, want_grad, rtol=0,
        atol=GRAD_ATOL_FRACTION * np.abs(want_grad).max())


def test_outputs_match_jax(pipelines):
    """Eager MapSet and the compiled template's histograms and mixture
    inputs, each container, within 1e-12."""
    want_eager, jax_ct, _, ct, eager = pipelines
    assert [m.name for m in eager] == [m.name for m in want_eager]
    for m, w in zip(eager, want_eager):
        np.testing.assert_allclose(m.hist, w.hist, rtol=1e-12)
    assert ct.free_names == jax_ct.free_names == ["aeff_scale"]
    v = _points(ct)["up"]
    got, want = ct(v), jax_ct(jnp.asarray(v))
    for key in ("hist",) + LLH_KEYS:
        assert set(got[key]) == set(want[key]) == {"nue_cc", "numu_cc"}
        for name in got[key]:
            np.testing.assert_allclose(got[key][name].numpy(),
                                       np.asarray(want[key][name]),
                                       rtol=1e-12, err_msg=f"{key} {name}")
    assert np.all(got["llh_alphas"]["numu_cc"].numpy() > 0)


@pytest.mark.parametrize("sum_maps", [False, True])
def test_generalized_objective_matches_jax(pipelines, sum_maps):
    _, jax_ct, _, ct, _ = pipelines
    data = {n: np.asarray(h) for n, h in jax_ct(
        jnp.asarray(jax_ct.current_rescaled_values()))["hist"].items()}
    _, jax_vg = jax_ct.build_objective(data, "generalized_poisson_llh",
                                       sum_maps=sum_maps)
    _, vg = ct.build_objective(data, "generalized_poisson_llh",
                               sum_maps=sum_maps)
    for v in _points(ct).values():
        _check_objective(vg(v), jax_vg(jnp.asarray(v)))


def test_generalized_objective_needs_the_mixture_inputs(two_stage_cfgs):
    """A template whose pipeline makes no llh_alphas cannot take the
    generalized likelihood, and says what is missing."""
    ct = Pipeline(two_stage_cfgs["single"], device="cpu").compile()
    data = {m.name: m.hist for m in ct.get_outputs()}
    value_fn, _ = ct.build_objective(data, "generalized_poisson_llh")
    with pytest.raises(ValueError, match="llh_alphas"):
        value_fn(ct.current_rescaled_values())


def _variance(hist, seed=3):
    rng = np.random.RandomState(seed)
    return rng.uniform(0.2, 1.0, hist.shape) * (hist + 1.0)


@pytest.mark.parametrize("metric", MC_METRICS)
def test_mc_metrics_through_compiled_distribution_match_jax(two_stage_cfgs,
                                                            metric):
    jax_cd = JaxCompiled(JaxPipeline(two_stage_cfgs["single"]))
    cd = CompiledDistribution(Pipeline(two_stage_cfgs["single"],
                                       device="cpu"))
    data = jax_cd.sum_hist(jax_cd.current_rescaled_values())
    var = _variance(np.asarray(data))
    _, jax_vg = jax_cd.build_objective(data, metric, data_variance=var)
    _, vg = cd.build_objective(data, metric, data_variance=var)
    for v in _points(cd).values():
        _check_objective(vg(v), jax_vg(jnp.asarray(v)))


@pytest.fixture(scope="module")
def detectors(two_stage_cfgs):
    paths = [two_stage_cfgs["detA"], two_stage_cfgs["detB"]]
    return (JaxDetectors(paths, shared_params=["aeff_scale"]),
            Detectors(paths, shared_params=["aeff_scale"], device="cpu"))


@pytest.mark.parametrize("metric", MC_METRICS)
def test_mc_metrics_through_compiled_detectors_match_jax(detectors, metric):
    """The joint objective of two detectors, each detector's data a map
    with errors (the variance these metrics read)."""
    jax_det, det = detectors
    datas, jax_datas = [], []
    for i, dm in enumerate(jax_det.distribution_makers):
        m = dm.get_outputs(return_sum=True)[0]
        err = np.sqrt(_variance(m.hist, seed=10 + i))
        jax_datas.append(JaxMapSet([JaxMap(name=m.name, hist=m.hist,
                                           binning=m.binning,
                                           error_hist=err)]))
        port_binning = det.distribution_makers[i].pipelines[0].output_binning
        datas.append(MapSet([Map(name=m.name, hist=m.hist,
                                 binning=port_binning, error_hist=err)]))
    _, jax_vg = JaxCompiledDet(jax_det).build_objective(jax_datas, metric)
    cdet = CompiledDetectors(det)
    _, vg = cdet.build_objective(datas, metric)
    assert cdet.free_names == ["aeff_scale"]
    for v in _points(cdet).values():
        _check_objective(vg(v), jax_vg(jnp.asarray(v)))


@pytest.mark.parametrize("metric", MC_METRICS)
def test_metric_per_map_matches_jax(pipelines, metric):
    """``Map.metric_per_map`` with the expectation's variance from its
    errors."""
    want_maps, _, _, _, maps = pipelines
    for jm, m in zip(want_maps, maps):
        err = np.sqrt(_variance(jm.hist, seed=7))
        jax_exp = JaxMap(name=jm.name, hist=jm.hist * 1.1,
                         binning=jm.binning, error_hist=err)
        exp = Map(name=m.name, hist=m.hist * 1.1, binning=m.binning,
                  error_hist=err)
        np.testing.assert_allclose(m.metric_per_map(exp, metric),
                                   jm.metric_per_map(jax_exp, metric),
                                   rtol=VALUE_RTOL)


def test_high_statistics_gradient_is_finite():
    """At the flagship's 240,000 events every bin holds >100 MC events per
    source and takes the plain Poisson llh; the value equals the JAX
    package's. The JAX package's gradient is NaN there (its recursion,
    run to the data's largest count in bins whose mixture is discarded,
    overflows); the port's recursion length is that of the bins that use
    the mixture (1 here), and its gradient is finite and equals central
    differences of its value."""
    from pisa_tpu import ureg as jax_ureg
    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.utils.llh_defs.poisson import mixture_k_max

    cts = []
    for cls, u, kw in ((JaxPipeline, jax_ureg, {}),
                       (Pipeline, ureg, {"device": "cpu"})):
        p = cls(CFG, **kw)
        p.params["n_events"].value = 240000 * u.dimensionless
        p.setup()
        cts.append(p.compile())
    jax_ct, ct = cts
    out = ct(ct.current_rescaled_values())
    data = {n: h.numpy() for n, h in out["hist"].items()}
    n_mc = np.stack([out["n_mc_events"][n].numpy() for n in data])
    assert n_mc.min() > 100
    assert mixture_k_max(sum(data.values()), n_mc) == 1
    jax_value, jax_vg = jax_ct.build_objective(data,
                                               "generalized_poisson_llh")
    value_fn, vg = ct.build_objective(data, "generalized_poisson_llh")
    v = _points(ct)["up"]
    value, grad = vg(v)
    want_value, want_grad = jax_vg(jnp.asarray(v))
    np.testing.assert_allclose(float(value), float(want_value),
                               rtol=VALUE_RTOL)
    assert np.isnan(np.asarray(want_grad)).all()
    h = 1e-6
    fd = (float(value_fn(v + h)) - float(value_fn(v - h))) / (2 * h)
    np.testing.assert_allclose(grad.numpy(), [fd], rtol=1e-6)


def test_template_survives_an_eager_run():
    """An eager ``get_outputs`` after the compile leaves the template's
    outputs as they were (the JAX package's template of this pipeline
    fails after one: its container translates the generalized stage's
    binned weights back to events)."""
    p = Pipeline(CFG, device="cpu")
    ct = p.compile()
    v = _points(ct)["up"]
    before = {k: {n: t.clone() for n, t in d.items()}
              for k, d in ct(v).items()}
    p.get_outputs()
    after = ct(v)
    for key, by_name in before.items():
        for name, t in by_name.items():
            assert torch.equal(after[key][name], t), (key, name)


def test_lookup_indices_flat_matches_jax():
    """``add_indices``'s flat index per event, with events below, inside
    and above the binning in each dimension."""
    from pisa_tpu.core import binning as jax_binning
    from pisa_tpu.core import translation as jax_translation
    from pisa_tpu import ureg as jax_ureg
    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.core import binning, translation

    rng = np.random.RandomState(2)
    e = 10 ** rng.uniform(-0.5, 2.5, 400)
    cz = rng.uniform(-1.3, 1.3, 400)
    e[:2] = [1.0, 100.0]  # the edges: the last bin is closed
    grids = []
    for mod, u in ((jax_binning, jax_ureg), (binning, ureg)):
        grids.append(mod.MultiDimBinning([
            mod.OneDimBinning("true_energy", num_bins=8, is_log=True,
                              domain=[1, 100] * u.GeV),
            mod.OneDimBinning("true_coszen", num_bins=8, is_lin=True,
                              domain=[-1, 1]),
        ]))
    want = np.asarray(jax_translation.lookup_indices_flat(
        [jnp.asarray(e), jnp.asarray(cz)], grids[0]))
    got = translation.lookup_indices_flat(
        [torch.as_tensor(e), torch.as_tensor(cz)], grids[1])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1).any() and (want == 64).any()
