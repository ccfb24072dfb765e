"""
The port's KDE path against the JAX package's, in fp64 on the CPU
(conftest), where the ``kde_gauss_sum`` / ``kde_gauss_sum_vjp`` kernels run
as their plain versions (``pisa_tpu_torch/ops/kde.py``):
``utils/kde.py:adaptive_gaussian_kde`` (adaptive on and off, Scott and
Silverman), ``kde_histogramdd`` (reflection, oversampling, PID stacking,
coszen off the first axis, bootstrap), the ``utils.kde`` stage (per
container with bootstrap and stash, stacked in a compiled template),
``utils/vbwkde.py``, the autograd Function's backward against
``torch.autograd.gradcheck``, its vmap rule and a template's lanes, and
``settings/pipeline/kde_example.cfg``: its maps, and the compiled
``value_and_grad`` of ``mod_chi2`` at a moved point against the JAX
``CompiledTemplate``'s (there with fast_example's 24x24 oscillation grid,
``_coarse``). No heavy set-up is shared between tests through a fixture:
each xdist worker would build it again. The kernels themselves are held
against the plain versions on a card (``cuda`` marker; skipped without
one).

Tolerances: densities and histograms 1e-10 relative (the same sums, in
another order, with the samples scaled by 1/h before the difference rather
than after); maps 1e-9 of each map's largest bin; the compiled value 1e-9
and each gradient entry 1e-8 relative; lanes against solo evaluations
1e-12; the card's float64 kernels 1e-12 and float32 1e-4 relative of the
largest entry (20,000-term sums in float32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pisa_tpu.core import binning as jax_binning
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu.stages.utils import kde as jax_kde_stage
from pisa_tpu.testing import service_matrix as JSM
from pisa_tpu.utils import kde as jax_kde
from pisa_tpu.utils import vbwkde as jax_vbwkde
from pisa_tpu_torch.core import binning as torch_binning
from pisa_tpu_torch.core.pipeline import Pipeline as TorchPipeline
from pisa_tpu_torch.ops import kde as ops_kde
from pisa_tpu_torch.stages.utils import kde as torch_kde_stage
from pisa_tpu_torch.testing import service_matrix as TSM
from pisa_tpu_torch.utils import kde as torch_kde
from pisa_tpu_torch.utils import vbwkde as torch_vbwkde
from pisa_tpu_torch.utils.interop import (
    template_inputs_from_jax,
    to_template_order,
)

KDE_RTOL = 1e-10
MAP_TOL = 1e-9
VALUE_RTOL = 1e-9
GRAD_RTOL = 1e-8
SELF_RTOL = 1e-12
KDE_CFG = "settings/pipeline/kde_example.cfg"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def _rel(got, want):
    want = np.asarray(want)
    return np.max(np.abs(np.asarray(got) - want)) / np.abs(want).max()


# -- the density ------------------------------------------------------------------
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("bw_method", ["scott", "silverman"])
def test_adaptive_gaussian_kde_matches_jax(bw_method, adaptive):
    rng = np.random.RandomState(0)
    x = np.stack([rng.normal(2.0, 0.7, 400), rng.uniform(-1, 1, 400)])
    w = rng.uniform(0.2, 2.0, 400)
    p = np.stack([rng.uniform(0, 4, 60), rng.uniform(-1.2, 1.2, 60)])
    want = np.asarray(jax_kde.adaptive_gaussian_kde(
        x, w, p, bw_method=bw_method, adaptive=adaptive, alpha=0.3))
    got = torch_kde.adaptive_gaussian_kde(
        torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(p),
        bw_method=bw_method, adaptive=adaptive, alpha=0.3)
    assert _rel(got.numpy(), want) <= KDE_RTOL
    # a batch of three evaluates each entry as alone
    xb = torch.as_tensor(np.stack([x, x[:, ::-1].copy(), x * 1.1]))
    wb = torch.as_tensor(np.stack([w, w[::-1].copy(), w * 0.5]))
    batched = torch_kde.adaptive_gaussian_kde(
        xb, wb, torch.as_tensor(p), bw_method=bw_method, adaptive=adaptive,
        alpha=0.3)
    for i in range(3):
        solo = torch_kde.adaptive_gaussian_kde(
            xb[i], wb[i], torch.as_tensor(p), bw_method=bw_method,
            adaptive=adaptive, alpha=0.3)
        assert _rel(batched[i].numpy(), solo.numpy()) <= SELF_RTOL


def _binning(b, names_bins, pid=True):
    dims = []
    for name, nb, dom in names_bins:
        dims.append(b.OneDimBinning(name, num_bins=nb, is_lin=True,
                                    domain=dom))
    if pid:
        dims.insert(1, b.OneDimBinning("pid", bin_edges=[-0.5, 0.5, 1.5]))
    return b.MultiDimBinning(dims, name="kde_test")


HISTDD_CASES = {
    # (dims, stack_pid, oversample, coszen_reflection)
    "pid_reflect_oversample": ((("energy", 6, [0, 10]),
                                ("coszen", 4, [-1, 1])), True, 2, 0.25),
    "coszen_last": ((("a", 3, [0, 1]), ("b", 4, [0, 1]),
                     ("coszen", 5, [-1, 1])), False, 1, 0.25),
    "no_reflection": ((("coszen", 5, [-0.8, 0.8]),
                       ("energy", 4, [0, 10])), True, 3, 0.25),
}


@pytest.mark.parametrize("case", sorted(HISTDD_CASES))
def test_kde_histogramdd_matches_jax(case):
    dims, stack_pid, oversample, refl = HISTDD_CASES[case]
    rng = np.random.RandomState(1)
    n = 500
    cols = []
    for name, _, dom in dims:
        cols.append(rng.uniform(dom[0], dom[1], n))
    if stack_pid:
        cols.insert(1, rng.choice([0.0, 1.0], n))
    sample = np.stack(cols, axis=1)
    w = rng.uniform(0.5, 1.5, n)
    kw = dict(weights=w, stack_pid=stack_pid, oversample=oversample,
              coszen_reflection=refl, bw_method="silverman", alpha=0.1)
    want = np.asarray(jax_kde.kde_histogramdd(
        sample, _binning(jax_binning, dims, stack_pid), **kw))
    got = torch_kde.kde_histogramdd(
        sample, _binning(torch_binning, dims, stack_pid), device="cpu", **kw)
    assert got.shape == want.shape
    assert _rel(got, want) <= KDE_RTOL
    # tensors in, tensors out, differentiable in the weights
    wt = torch.as_tensor(w, dtype=torch.float64).requires_grad_(True)
    t = torch_kde.kde_histogramdd(
        torch.as_tensor(sample), _binning(torch_binning, dims, stack_pid),
        **dict(kw, weights=wt))
    t.sum().backward()
    assert _rel(t.detach().numpy(), want) <= KDE_RTOL
    assert torch.isfinite(wt.grad).all()


def test_kde_histogramdd_bootstrap_matches_jax():
    dims = (("energy", 5, [0, 10]), ("coszen", 4, [-1, 1]))
    rng = np.random.RandomState(2)
    n = 300
    sample = np.stack([rng.uniform(0, 10, n), rng.choice([0.0, 1.0], n),
                       rng.uniform(-1, 1, n)], axis=1)
    w = rng.uniform(0.5, 1.5, n)
    kw = dict(weights=w, stack_pid=True, bootstrap=True, bootstrap_niter=4,
              bootstrap_seed=3)
    want = jax_kde.kde_histogramdd(sample, _binning(jax_binning, dims), **kw)
    got = torch_kde.kde_histogramdd(sample, _binning(torch_binning, dims),
                                    device="cpu", **kw)
    for g, w_ in zip(got, want):
        assert _rel(g, w_) <= KDE_RTOL
    with pytest.raises(TypeError, match="host"):
        torch_kde.kde_histogramdd(
            torch.as_tensor(sample), _binning(torch_binning, dims),
            **dict(kw, weights=torch.as_tensor(w).requires_grad_(True)))


def test_zero_weight_channel_gives_zeros_and_a_finite_gradient():
    """An empty PID channel (every weight zero; h clamped to 1e-30, so the
    scaled differences overflow) gives zeros, not NaN, and the gradient of
    the whole histogram with respect to the weights is finite; a NaN
    coordinate on a zero-weight event poisons nothing."""
    rng = np.random.RandomState(3)
    n = 300
    sample = np.stack([rng.uniform(1, 9, n), np.zeros(n),
                       rng.uniform(-0.9, 0.9, n)], axis=1)
    sample[0, 0] = np.nan
    w = np.ones(n)
    w[0] = 0.0
    binning = _binning(torch_binning, (("energy", 6, [0, 10]),
                                       ("coszen", 4, [-1, 1])))
    # alpha = 1 in float32: the empty channel's widths lambda reach
    # tiny^-1, their 1 / lambda^2 underflows to 0 beside distances that
    # overflow, and 0 * inf in the exponent must still give a zero kernel
    for dtype, alpha in ((torch.float64, 0.3), (torch.float32, 0.3),
                         (torch.float32, 1.0)):
        wt = torch.as_tensor(w, dtype=dtype).requires_grad_(True)
        h = torch_kde.kde_histogramdd(torch.as_tensor(sample, dtype=dtype),
                                      binning, weights=wt, stack_pid=True,
                                      alpha=alpha)
        assert torch.isfinite(h).all()
        assert (h[:, 1] == 0).all()
        (h * torch.arange(h.numel(), dtype=dtype).reshape(h.shape)).sum() \
            .backward()
        assert torch.isfinite(wt.grad).all(), dtype
    want = np.asarray(jax_kde.kde_histogramdd(
        sample, _binning(jax_binning, (("energy", 6, [0, 10]),
                                       ("coszen", 4, [-1, 1]))),
        weights=w, stack_pid=True))
    got = torch_kde.kde_histogramdd(sample, binning, weights=w,
                                    stack_pid=True, device="cpu")
    assert _rel(got, want) <= KDE_RTOL


@pytest.mark.parametrize("adaptive", [True, False])
def test_density_backward_passes_gradcheck(adaptive):
    """The hand-written backward of ``AdaptiveDensity`` (through the plain
    versions of both kernels) against finite differences, in fp64."""
    rng = np.random.RandomState(4)
    x = torch.as_tensor(rng.normal(size=(3, 2, 25)))
    w = torch.as_tensor(rng.uniform(0.5, 2, (3, 25)))
    w = (w / w.sum(-1, keepdim=True)).requires_grad_(True)
    h = torch.as_tensor(rng.uniform(0.3, 0.6, (3, 2))).requires_grad_(True)
    p = torch.as_tensor(rng.normal(size=(2, 7)))
    assert torch.autograd.gradcheck(
        lambda w_, h_: ops_kde.adaptive_density(x, w_, h_, p, adaptive, 0.3),
        (w, h))


def test_density_vmap_rule_and_no_forward_mode():
    rng = np.random.RandomState(5)
    x = torch.as_tensor(rng.normal(size=(2, 2, 30)))
    h = torch.as_tensor(rng.uniform(0.3, 0.6, (2, 2)))
    p = torch.as_tensor(rng.normal(size=(2, 9)))
    w = torch.as_tensor(rng.uniform(0.5, 2, (4, 2, 30)))
    w = w / w.sum(-1, keepdim=True)

    def f(w_):
        return ops_kde.adaptive_density(x, w_, h, p, True, 0.3)

    batched = torch.func.vmap(f)(w)
    for i in range(4):
        assert _rel(batched[i].numpy(), f(w[i]).numpy()) <= SELF_RTOL
    # forward mode is defined (no longer raises) and is the transpose of
    # the backward: <g, J dw> = <J^T g, dw> (test_torch_kde_forward.py
    # holds it against jacrev)
    dw = torch.as_tensor(rng.normal(size=(2, 30)))
    g = torch.as_tensor(rng.normal(size=(2, 9)))
    _, tangent = torch.func.jvp(f, (w[0],), (dw,))
    _, vjp_fn = torch.func.vjp(f, w[0])
    lhs = float((g * tangent).sum())
    assert abs(lhs - float((vjp_fn(g)[0] * dw).sum())) <= SELF_RTOL * abs(
        lhs)


def test_kernel_wrappers_check_their_inputs():
    x = torch.zeros(2, 2, 5, dtype=torch.float64)
    p = torch.zeros(2, 3, dtype=torch.float64)
    ih, il2, c = torch.ones(2, 2, dtype=torch.float64), torch.ones(
        2, 5, dtype=torch.float64), torch.ones(2, 5, dtype=torch.float64)
    assert ops_kde.gauss_sum(x, p, ih, il2, c).shape == (2, 3)
    with pytest.raises(ValueError):
        ops_kde.gauss_sum(torch.zeros(2, 4, 5, dtype=torch.float64),
                          torch.zeros(4, 3, dtype=torch.float64),
                          torch.ones(2, 4, dtype=torch.float64), il2, c)
    with pytest.raises(ValueError):
        ops_kde.gauss_sum(x, p, ih, il2, c.float())
    with pytest.raises(ValueError):
        ops_kde.gauss_sum_vjp(x, p, ih, il2, torch.ones(2, 4,
                                                        dtype=torch.float64))
    ops = ops_kde.kde_operations("sum", 24, 2, 20000, 20000)
    assert ops["flops"] == 8 * ops["pairs"] and ops["exps"] == ops["pairs"]
    assert ops_kde.kde_operations("vjp", 1, 2, 3, 4)["flops"] == 12 * 12
    ms, by = ops_kde.kde_bound_ms("sum", 24, 2, 20000, 20000, torch.float32)
    assert by == "operations" and ms == pytest.approx(
        9.6e9 / ops_kde.MUFU_EXP_PER_S * 1e3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-4)])
def test_kernels_match_plain_versions_on_card(cuda_device, dtype, rtol):
    g = torch.Generator().manual_seed(0)
    B, D, N, M = 6, 2, 3000, 500
    x = torch.randn(B, D, N, generator=g, dtype=torch.float64)
    p = torch.randn(D, M, generator=g, dtype=torch.float64)
    ih = torch.full((B, D), 4.0, dtype=torch.float64)
    ih[1] = 1e30  # a zero-weight channel's bandwidth
    il2 = 0.5 + torch.rand(B, N, generator=g, dtype=torch.float64)
    c = torch.rand(B, N, generator=g, dtype=torch.float64) / N
    c[1] = 0
    gg = torch.randn(B, M, generator=g, dtype=torch.float64)
    want = ops_kde.gauss_sum(x, p, ih, il2, c)
    want_a, want_c = ops_kde.gauss_sum_vjp(x, p, ih, il2, gg)
    dev = [t.to(cuda_device, dtype) for t in (x, p, ih, il2, c, gg)]
    got = ops_kde.gauss_sum(*dev[:5])
    got_a, got_c = ops_kde.gauss_sum_vjp(*dev[:4], dev[5])
    torch.cuda.synchronize()
    for a, b in ((got, want), (got_a, want_a), (got_c, want_c)):
        assert torch.isfinite(a).all()
        assert _rel(a.double().cpu().numpy(), b.numpy()) <= rtol


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-4)])
def test_kernels_with_live_counts_match_plain_versions_on_card(
        cuda_device, dtype, rtol, splits):
    """Live counts below N (a full row, a partial one, an empty one, a
    one-sample one, and a row whose bandwidth is 1e-30), the pilot's
    per-row points and the grid's shared ones, at the wrapper's split
    count and at forced ones; the same result from run to run."""
    g = torch.Generator().manual_seed(1)
    B, D, N, M = 5, 2, 3000, 500
    counts = torch.tensor([3000, 1234, 0, 1, 2000], dtype=torch.int32)
    x = torch.randn(B, D, N, generator=g, dtype=torch.float64)
    x[(torch.arange(N) >= counts[:, None].long()).unsqueeze(1)
      .expand_as(x)] = float("nan")  # padding past the counts
    p = torch.randn(D, M, generator=g, dtype=torch.float64)
    ih = torch.full((B, D), 4.0, dtype=torch.float64)
    ih[4] = 1e30
    il2 = 0.5 + torch.rand(B, N, generator=g, dtype=torch.float64)
    c = torch.rand(B, N, generator=g, dtype=torch.float64) / N
    gp = torch.randn(B, N, generator=g, dtype=torch.float64)
    gg = torch.randn(B, M, generator=g, dtype=torch.float64)
    cases = (("sum", (x, x, ih, il2, c), counts, counts),
             ("sum", (x, p, ih, il2, c), counts, None),
             ("vjp", (x, x, ih, il2, gp), counts, counts),
             ("vjp", (x, p, ih, il2, gg), counts, None))
    dev_counts = counts.to(cuda_device)
    for kind, args, n_live, m_live in cases:
        fn = ops_kde.gauss_sum if kind == "sum" else ops_kde.gauss_sum_vjp
        want = fn(*args, n_live, m_live)
        want = (want,) if kind == "sum" else want
        dev = [t.to(cuda_device, dtype) for t in args]
        m_dev = None if m_live is None else dev_counts
        got = fn(*dev, dev_counts, m_dev, splits=splits)
        again = fn(*dev, dev_counts, m_dev, splits=splits)
        torch.cuda.synchronize()
        got = (got,) if kind == "sum" else got
        again = (again,) if kind == "sum" else again
        for a, b, a2 in zip(got, want, again):
            assert torch.isfinite(a).all()
            assert torch.equal(a, a2)
            assert _rel(a.double().cpu().numpy(), b.numpy()) <= rtol


# -- vbwkde ----------------------------------------------------------------------
def test_vbwkde_and_isj_match_jax():
    rng = np.random.RandomState(6)
    data = np.concatenate([rng.normal(-3, 0.5, 800), rng.normal(3, 1.0,
                                                                800)])
    w = rng.uniform(0.5, 1.5, data.size)
    for fn in ("fbwkde", "vbwkde"):
        got = getattr(torch_vbwkde, fn)(data, weights=w, n_dct=512)
        want = getattr(jax_vbwkde, fn)(data, weights=w, n_dct=512)
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g, w_, rtol=1e-12)
    hist = np.histogram(data, bins=256)[0] / data.size
    np.testing.assert_allclose(
        torch_vbwkde.isj_bandwidth(hist, data.size, 12.0)[0],
        jax_vbwkde.isj_bandwidth(hist, data.size, 12.0)[0], rtol=1e-12)
    x = np.linspace(-5, 5, 41)
    np.testing.assert_allclose(
        torch_vbwkde.gaussians(x, data[:50], np.full(50, 0.3)),
        jax_vbwkde.gaussians(x, data[:50], np.full(50, 0.3)), rtol=1e-14)


# -- the stage -----------------------------------------------------------------------
def _stage_pair(**options):
    """The kde service's ``init_test`` from both packages with `options`,
    on each harness's synthetic containers for one seed, set up."""
    out = []
    for module, harness, kw in ((jax_kde_stage, JSM, {}),
                                (torch_kde_stage, TSM, {"device": "cpu"})):
        stage = module.init_test()
        for k, v in options.items():
            setattr(stage, k, v)
        stage.stashed_hists = stage.stashed_errors = None
        stage.data = harness.make_events_data(stage, np.random.RandomState(8),
                                              **kw)
        stage.setup()
        out.append(stage)
    return out


def _weights(stage, key="weights"):
    return {c.name: (c[key].numpy() if isinstance(c[key], torch.Tensor)
                     else np.asarray(c[key])) for c in stage.data}


@pytest.mark.parametrize("options", [{}, {"bootstrap": True,
                                          "bootstrap_niter": 3,
                                          "bootstrap_seed": 4,
                                          "oversample": 1}])
def test_kde_stage_matches_jax(options):
    """Per container, with bootstrap errors, stashed: the second run takes
    the stash (the same values), as in the JAX stage."""
    options = dict(options, stash_hists=True)
    jstage, stage = _stage_pair(**options)
    for s in (jstage, stage):
        s.run()
    keys = ["weights"] + (["errors"] if options.get("bootstrap") else [])
    for key in keys:
        want, got = _weights(jstage, key), _weights(stage, key)
        for name in want:
            assert _rel(got[name], want[name]) <= KDE_RTOL, (key, name)
    first = _weights(stage)
    stage.run()
    assert stage.stash_valid
    for name, v in _weights(stage).items():
        np.testing.assert_array_equal(v, first[name])
    assert TSM.run_service("utils", "kde", "events", device="cpu") == "ok"


def test_stash_refuses_inside_a_compiled_template():
    (stage,) = _stage_pair(stash_hists=True)[1:]
    stage._template_mode = True
    with pytest.raises(TypeError, match="stash_hists"):
        stage.run()


# -- kde_example.cfg ---------------------------------------------------------------
def _coarse(parse):
    """kde_example with fast_example's 24x24 oscillation grid: the KDE stage
    and everything else as configured; prob3's plain tangents on the
    200x200 grid would take ~12 s of the CPU's time for each gradient here
    (the full config's gradient is held card against CPU in float64 by
    chip_smoke.py)."""
    cfg = parse(KDE_CFG)
    cfg[("osc", "prob3")]["calc_mode"] = parse(
        "settings/pipeline/fast_example.cfg")[("osc", "prob3")]["calc_mode"]
    return cfg


def test_kde_example_maps_match_jax():
    """kde_example's eager maps against the JAX package's, and the port's
    compiled template (stacked) at the nominal point against them."""
    pipeline = TorchPipeline(KDE_CFG, device="cpu")
    got = pipeline.get_outputs()
    want = JaxPipeline(KDE_CFG).get_outputs()
    assert [m.name for m in got] == [m.name for m in want]
    for m in want:
        ref = np.asarray(m.hist)
        np.testing.assert_allclose(got[m.name].hist, ref, rtol=MAP_TOL,
                                   atol=MAP_TOL * np.abs(ref).max(),
                                   err_msg=m.name)
    ct = pipeline.compile()
    assert ct.stacked and not ct.rate_deferred
    hist = ct(ct.current_rescaled_values())["hist"]
    for m in got:
        assert _rel(hist[m.name].numpy(), m.hist.reshape(-1)) <= SELF_RTOL


def test_kde_example_value_and_grad_matches_jax():
    """The compiled mod_chi2 value and gradient (delta_index, theta23,
    aeff_scale free) at a moved point against the JAX CompiledTemplate's,
    the port's template stacked: the KDE of all 12 categories x 2 PID
    channels in one batch (on the 24x24 oscillation grid, with the port's
    eager maps as data for both); then two points as lanes of the port's
    batched objective against each point alone."""
    from pisa_tpu.config.parser import parse_pipeline_config as jax_parse
    from pisa_tpu_torch.config.parser import parse_pipeline_config

    pipeline = TorchPipeline(_coarse(parse_pipeline_config), device="cpu")
    data = {m.name: m.hist for m in pipeline.get_outputs()}
    jax_ct = JaxPipeline(_coarse(jax_parse)).compile()
    _, jax_vg = jax_ct.build_objective(data, "mod_chi2")
    v0 = np.asarray(jax_ct.current_rescaled_values())
    v = np.clip(v0 + np.random.RandomState(5).uniform(-0.1, 0.1, v0.size),
                0.05, 0.95)
    want_value, want_grad = jax_vg(jnp.asarray(v))
    ct = pipeline.compile()
    assert ct.stacked and not ct.rate_deferred
    assert sorted(ct.free_names) == sorted(jax_ct.free_names)
    want_grad = to_template_order(ct, jax_ct.free_names,
                                  np.asarray(want_grad))
    vec, los, his = template_inputs_from_jax(
        ct, jax_ct.free_names, v,
        *[np.asarray(b) for b in jax_ct._current_bounds()])
    value_fn, vg = ct.build_objective(data, "mod_chi2")
    before = (ops_kde.sum_launch_count, ops_kde.vjp_launch_count)
    value, grad = vg(vec)
    assert (ops_kde.sum_launch_count, ops_kde.vjp_launch_count) == before
    assert abs(float(value) - float(want_value)) <= VALUE_RTOL * abs(
        float(want_value))
    np.testing.assert_allclose(np.asarray(grad), want_grad, rtol=GRAD_RTOL,
                               atol=0)
    # lanes of the batched objective
    los, his = ct._device_bounds()
    vecs = torch.as_tensor(np.stack([vec, np.clip(vec + 0.07, 0, 1)]))
    with torch.no_grad():
        values = value_fn.raw_with_data(vecs, los, his)
        for i in range(2):
            solo = float(value_fn.raw(vecs[i], los, his))
            assert abs(float(values[i]) - solo) <= SELF_RTOL * abs(solo)


def test_plan_lanes_equal_solo_evaluations():
    """Lanes: a KDE plan of stacked categories with weights (B, C, N) (the
    lane axis joins the kernels' batch) against each lane alone, values and
    gradients."""
    rng = np.random.RandomState(7)
    binning = _binning(torch_binning, (("energy", 5, [0, 10]),
                                       ("coszen", 4, [-1, 1])))
    plan = torch_kde.KDEPlan(binning, oversample=2, device="cpu")
    sample = torch.as_tensor(np.stack([
        rng.uniform(0, 10, (3, 120)), rng.choice([0.0, 1.0], (3, 120)),
        rng.uniform(-1, 1, (3, 120))], axis=-1))
    w = torch.as_tensor(rng.uniform(0.5, 1.5, (2, 3, 120)))
    w.requires_grad_(True)
    lanes = plan(sample, w)
    (g_lanes,) = torch.autograd.grad((lanes * lanes).sum(), w)
    for i in range(2):
        wi = w[i].detach().clone().requires_grad_(True)
        solo = plan(sample, wi)
        (g_solo,) = torch.autograd.grad((solo * solo).sum(), wi)
        assert _rel(lanes[i].detach().numpy(), solo.detach().numpy()) \
            <= SELF_RTOL
        assert _rel(g_lanes[i].numpy(), g_solo.numpy()) <= SELF_RTOL
