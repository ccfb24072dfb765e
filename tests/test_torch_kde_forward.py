"""
Forward mode through the port's adaptive KDE, in fp64 on the CPU
(conftest), where the ``kde_gauss_sum_jvp`` kernel runs as its plain
version (``pisa_tpu_torch/ops/kde.py:gauss_sum_jvp_reference``): the plain
version against ``torch.func.jvp`` of the sum's plain version;
``AdaptiveDensity``'s jvp and ``jacfwd`` against ``torch.func.jacrev`` of
the same density written in plain torch ops; the Fisher matrix of a small
``kde_example.cfg`` toy against the JAX package's
(``pisa_tpu/analysis/fisher.py``, ``jacfwd`` through XLA). The kernel
itself is held against the plain version on a card (``cuda`` marker;
skipped without one).

Tolerances: the plain jvp 1e-12 relative of the largest entry (the same
sums, the tangent's terms in another order); the density's jvp and jacfwd
1e-10 (the density's own, ``test_torch_kde.py``); the Fisher matrix 1e-8
of its largest entry (the gradient's, ``test_rate_defer.py``); the card's
float64 kernel 1e-12 and float32 1e-4 of the largest entry (20,000-term
sums in float32).
"""

import numpy as np
import pytest
import torch

from pisa_tpu.analysis.fisher import get_fisher_matrix as jax_fisher
from pisa_tpu.config.parser import parse_pipeline_config as jax_parse
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu_torch.analysis.fisher import get_fisher_matrix
from pisa_tpu_torch.config.parser import parse_pipeline_config
from pisa_tpu_torch.core.pipeline import Pipeline as TorchPipeline
from pisa_tpu_torch.ops import kde as ops_kde
from pisa_tpu_torch.scripts.make_toy_events import make_toy_events

PLAIN_RTOL = 1e-12
DENSITY_RTOL = 1e-10
FISHER_RTOL = 1e-8
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


def _sum_inputs(dims, shared, zero_channel, seed=3):
    """x (B, D, N), points, ih, il2, c and the tangents dih, dil2, dc; with
    `zero_channel` batch row 1 is a zero-weight channel (ih 1e30, c 0)."""
    rng = np.random.RandomState(seed)
    B, N, M = 3, 60, 45
    t = lambda *shape: torch.as_tensor(rng.normal(size=shape))  # noqa: E731
    x = t(B, dims, N)
    p = t(dims, M) if shared else t(B, dims, M)
    ih = torch.as_tensor(rng.uniform(1.0, 3.0, (B, dims)))
    il2 = torch.as_tensor(rng.uniform(0.5, 2.0, (B, N)))
    c = torch.as_tensor(rng.uniform(0.0, 1.0, (B, N)))
    if zero_channel:
        ih[1] = 1e30
        c[1] = 0.0
    return (x, p, ih, il2, c), (t(B, dims), t(B, N), t(B, N))


@pytest.mark.parametrize("zero_channel", [False, True])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("dims", [1, 2, 3])
def test_jvp_plain_version_matches_jvp_of_the_sum(dims, shared,
                                                  zero_channel):
    (x, p, ih, il2, c), (dih, dil2, dc) = _sum_inputs(dims, shared,
                                                      zero_channel)
    if zero_channel:
        dih[1] = 0.0  # a clamped bandwidth has no tangent
    out, dout = ops_kde.gauss_sum_jvp_reference(x, p, ih, dih, il2, dil2, c,
                                                dc)
    assert torch.isfinite(dout).all()
    np.testing.assert_array_equal(
        out.numpy(), ops_kde.gauss_sum_reference(x, p, ih, il2, c).numpy())
    live = slice(None) if not zero_channel else [0, 2]
    want_out, want = torch.func.jvp(
        lambda a, b, cc: ops_kde.gauss_sum_reference(x[live], p if shared
                                                     else p[live], a, b, cc),
        (ih[live], il2[live], c[live]), (dih[live], dil2[live], dc[live]))
    assert _rel(dout[live].numpy(), want.numpy()) <= PLAIN_RTOL
    if zero_channel:
        assert (out[1] == 0).all() and (dout[1] == 0).all()
    # the wrapper takes the plain version on the CPU and launches nothing
    before = ops_kde.jvp_launch_count
    got = ops_kde.gauss_sum_jvp(x, p, ih, dih, il2, dil2, c, dc)
    assert ops_kde.jvp_launch_count == before
    np.testing.assert_array_equal(got[1].numpy(), dout.numpy())


def test_jvp_wrapper_checks_its_tangents():
    (x, p, ih, il2, c), (dih, dil2, dc) = _sum_inputs(2, True, False)
    with pytest.raises(ValueError, match="dih"):
        ops_kde.gauss_sum_jvp(x, p, ih, dih[:, :1], il2, dil2, c, dc)
    with pytest.raises(ValueError, match="dc"):
        ops_kde.gauss_sum_jvp(x, p, ih, dih, il2, dil2, c, dc[:, :5])
    with pytest.raises(ValueError, match="type and device"):
        ops_kde.gauss_sum_jvp(x, p, ih, dih, il2, dil2.float(), c, dc)
    # 4D + 2 operations a pair shared by the directions, 2D + 2 for each
    assert ops_kde.kde_operations("jvp", 1, 2, 3, 4)["flops"] == 12 * 16
    assert ops_kde.kde_operations("jvp", 1, 2, 3, 4,
                                  directions=3)["flops"] == 12 * 28
    # float32 at D = 3: 22 operations a pair on the FMA pipe take longer
    # than the pair's exp on the special-function unit
    pairs = 24 * 20000 * 1320
    ms, by = ops_kde.kde_bound_ms("jvp", 24, 3, 20000, 1320, torch.float32)
    assert by == "operations" and ms == pytest.approx(
        pairs * 22 / ops_kde.FP32_FLOPS * 1e3)
    ms, by = ops_kde.kde_bound_ms("jvp", 24, 1, 20000, 1320, torch.float32)
    assert by == "operations" and ms == pytest.approx(
        pairs / ops_kde.MUFU_EXP_PER_S * 1e3)


def _density_inputs(seed=5):
    rng = np.random.RandomState(seed)
    B, D, N, M = 3, 2, 40, 30
    x = torch.as_tensor(rng.normal(size=(B, D, N)))
    p = torch.as_tensor(rng.normal(size=(D, M)))
    w = torch.as_tensor(rng.uniform(0.2, 1.0, (B, N)))
    w = w / w.sum(-1, keepdim=True)
    h = torch.as_tensor(rng.uniform(0.3, 0.8, (B, D)))
    dw = torch.as_tensor(rng.normal(size=(B, N)))
    dh = torch.as_tensor(rng.normal(size=(B, D)))
    return x, p, w, h, dw, dh


def _plain_density(x, p, adaptive, alpha):
    """The density of AdaptiveDensity in plain torch ops, every step
    differentiable by autograd (the pilot included)."""
    def f(w, h):
        pilot = torch.ones_like(w)
        if adaptive:
            q = ops_kde._widths(x, w, h, pilot, False, alpha)
            pilot = ops_kde.gauss_sum_reference(x, x, q["ih"], pilot,
                                                q["c0"])
        q = ops_kde._widths(x, w, h, pilot, adaptive, alpha)
        return ops_kde.gauss_sum_reference(x, p, q["ih"], q["il2"], q["c"])
    return f


@pytest.mark.parametrize("adaptive", [True, False])
def test_density_jvp_and_jacfwd_match_jacrev(adaptive):
    x, p, w, h, dw, dh = _density_inputs()

    def f(w_, h_):
        return ops_kde.adaptive_density(x, w_, h_, p, adaptive, 0.3)

    plain = _plain_density(x, p, adaptive, 0.3)
    jw, jh = torch.func.jacrev(plain, argnums=(0, 1))(w, h)
    want = (torch.einsum("bmcn,cn->bm", jw, dw)
            + torch.einsum("bmcd,cd->bm", jh, dh))
    value, got = torch.func.jvp(f, (w, h), (dw, dh))
    assert _rel(value.numpy(), plain(w, h).numpy()) <= DENSITY_RTOL
    assert _rel(got.numpy(), want.numpy()) <= DENSITY_RTOL
    # one tangent alone (the other None inside the rule)
    _, got_w = torch.func.jvp(lambda w_: f(w_, h), (w,), (dw,))
    assert _rel(got_w.numpy(),
                torch.einsum("bmcn,cn->bm", jw, dw).numpy()) <= DENSITY_RTOL
    # jacfwd: the vmap rule folds the directions into the batch
    fw, fh = torch.func.jacfwd(f, argnums=(0, 1))(w, h)
    assert _rel(fw.numpy(), jw.numpy()) <= DENSITY_RTOL
    assert _rel(fh.numpy(), jh.numpy()) <= DENSITY_RTOL


def test_density_jvp_under_vmap_of_inputs():
    """vmap over weights of a jvp (lanes of directions and points): each
    lane's tangent equals its own jvp."""
    x, p, w, h, dw, dh = _density_inputs()
    ws = torch.stack([w, w.flip(-1)])
    dws = torch.stack([dw, -dw])

    def tangent(w_, dw_):
        return torch.func.jvp(
            lambda a: ops_kde.adaptive_density(x, a, h, p, True, 0.3),
            (w_,), (dw_,))[1]

    lanes = torch.func.vmap(tangent)(ws, dws)
    for i in range(2):
        assert _rel(lanes[i].numpy(), tangent(ws[i], dws[i]).numpy()) \
            <= DENSITY_RTOL


def _coarse(parse, toy_events=None):
    """kde_example with fast_example's 24x24 oscillation grid, on its own
    events file (100 events a flavour and interaction) or on toy events."""
    cfg = parse(KDE_CFG)
    cfg[("osc", "prob3")]["calc_mode"] = parse(
        "settings/pipeline/fast_example.cfg")[("osc", "prob3")]["calc_mode"]
    if toy_events:
        cfg[("data", "simple_data_loader")]["events_file"] = \
            make_toy_events(num_events=toy_events, seed=0)
    return cfg


def test_kde_example_fisher_matches_jax():
    """get_fisher_matrix (priors on) of the compiled kde_example, its
    jacfwd through the density's forward mode, against the JAX package's
    jacfwd through XLA."""
    ct = TorchPipeline(_coarse(parse_pipeline_config),
                       device="cpu").compile()
    assert ct.stacked
    got = get_fisher_matrix(ct)
    want = jax_fisher(JaxPipeline(_coarse(jax_parse)).compile())
    assert got.parameters == want.parameters
    ref = np.asarray(want.matrix)
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(got.matrix, ref, rtol=0,
                               atol=FISHER_RTOL * np.abs(ref).max())


def test_fisher_with_an_empty_pid_channel_is_finite():
    """Toy events whose numu CC PID values all fall in the track channel:
    the cascade channel has no weight. The JAX package's Fisher matrix is
    NaN there (its jacfwd meets 0 * inf in the empty channel); the port's
    guards keep the tangent 0 and the matrix finite."""
    ct = TorchPipeline(_coarse(parse_pipeline_config, toy_events=60),
                       device="cpu").compile()
    fm = get_fisher_matrix(ct)
    assert np.isfinite(fm.matrix).all()
    assert (np.diag(fm.matrix) > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-4)])
def test_jvp_kernel_matches_plain_version_on_card(cuda_device, dtype, rtol):
    (x, p, ih, il2, c), (dih, dil2, dc) = _sum_inputs(2, False, True)
    dih[1] = 0.0
    want = ops_kde.gauss_sum_jvp_reference(x, p, ih, dih, il2, dil2, c, dc)
    before = ops_kde.jvp_launch_count
    got = ops_kde.gauss_sum_jvp(*(t.to(cuda_device, dtype) for t in (
        x, p, ih, dih, il2, dil2, c, dc)))
    torch.cuda.synchronize()
    assert ops_kde.jvp_launch_count == before + 1
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _rel(a.double().cpu().numpy(), b.numpy()) <= rtol
