"""
The KDE's compacted layout (each PID channel's live samples first, with
live counts) against the dense one and against the JAX package, in fp64 on
the CPU (conftest), where the ``kde_gauss_sum`` / ``kde_gauss_sum_vjp`` /
``kde_gauss_sum_jvp`` kernels run as their plain versions with the same
counts (``pisa_tpu_torch/ops/kde.py``):

- the plain versions with live counts against the dense plain versions on
  rows with masked tails, an empty row and a one-sample row;
- ``utils/kde.py:KDEPlan.live_order`` (the PID cut and the stacking's
  padding, never the weights);
- ``kde_histogramdd`` and a stacked ``KDEPlan`` (padding slots, 3 lanes)
  against the JAX package's ``kde_histogramdd``, with kde_example's PID
  pattern (one category all tracks, so one channel empty; the others about
  3/4 cascades);
- the value and gradient of a chi-square over that stacked KDE against
  ``jax.value_and_grad``, at a point where some live samples have weight 0;
- ``torch.autograd.gradcheck`` and ``jacfwd`` against ``jacrev`` of
  ``AdaptiveDensity`` on the compacted layout; finite outputs and
  gradients with an empty and a one-sample channel, in float64 and
  float32.

Tolerances: plain versions with counts against dense 1e-12 relative of
the largest entry (the same terms, zeros left out); maps 1e-9 of each
map's largest bin; the value 1e-9 and each gradient entry 1e-8 relative
(those of ``tests/test_torch_kde.py::
test_kde_example_value_and_grad_matches_jax``); forward against reverse
mode 1e-10. No heavy set-up is shared through a fixture (each xdist
worker would build it again); each JAX evaluation sits in one test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pisa_tpu.core import binning as jax_binning
from pisa_tpu.utils import kde as jax_kde
from pisa_tpu_torch.core import binning as torch_binning
from pisa_tpu_torch.ops import kde as ops_kde
from pisa_tpu_torch.utils import kde as torch_kde

SELF_RTOL = 1e-12
MAP_TOL = 1e-9
VALUE_RTOL = 1e-9
GRAD_RTOL = 1e-8
FWD_RTOL = 1e-10
# kde_example's KDE options (settings/pipeline/kde_example.cfg): those of
# an evaluation, and those of the plan (its oversampling cut to 2)
KW = dict(bw_method="silverman", alpha=0.1)
PLAN_KW = dict(coszen_reflection=0.25, oversample=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    want = np.asarray(want)
    return np.max(np.abs(np.asarray(got) - want)) / np.abs(want).max()


def _map_rel(got, want):
    """Worst |got - want| over each map's bins relative to that map's
    largest bin (maps along the first axis)."""
    got, want = np.asarray(got), np.asarray(want)
    worst = 0.0
    for g, w in zip(got.reshape(len(got), -1), want.reshape(len(want), -1)):
        scale = np.abs(w).max()
        worst = max(worst, np.abs(g - w).max() / (scale if scale > 0
                                                   else 1.0))
    return worst


# -- the plain versions with live counts ------------------------------------------
def _kernel_inputs(dims, shared, seed=0):
    """Rows with masked tails, an empty row and a one-sample row: samples
    past each row's count have c = 0 and NaN coordinates where the layout
    would carry padding."""
    rng = np.random.RandomState(seed)
    B, N, M = 4, 40, 25
    counts = np.array([40, 17, 0, 1])
    x = rng.normal(size=(B, dims, N))
    p = rng.normal(size=(dims, M)) if shared else None
    ih = rng.uniform(1.0, 2.5, (B, dims))
    il2 = rng.uniform(0.5, 2.0, (B, N))
    c = rng.uniform(0.1, 1.0, (B, N))
    tail = np.arange(N)[None, :] >= counts[:, None]
    c[tail] = 0.0
    t = {k: torch.as_tensor(v) for k, v in dict(x=x, ih=ih, il2=il2, c=c)
         .items()}
    t["p"] = torch.as_tensor(p) if shared else t["x"]
    t["g"] = torch.as_tensor(rng.normal(size=(B, M if shared else N)))
    t["counts"] = torch.as_tensor(counts, dtype=torch.int32)
    t["tail"] = torch.as_tensor(tail)
    t["dih"] = torch.as_tensor(rng.normal(size=(B, dims)))
    t["dil2"] = torch.as_tensor(rng.normal(size=(B, N)))
    t["dc"] = torch.as_tensor(np.where(tail, 0.0, rng.normal(size=(B, N))))
    return t


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("dims", [1, 2, 3])
@pytest.mark.parametrize("kind", ["sum", "vjp", "jvp"])
def test_plain_versions_with_counts_equal_the_dense_ones(kind, dims, shared):
    t = _kernel_inputs(dims, shared)
    n = t["counts"]
    m = None if shared else n
    # the dense version on the same rows with NaN-free tails
    if kind == "sum":
        got = (ops_kde.gauss_sum(t["x"], t["p"], t["ih"], t["il2"], t["c"],
                                 n, m),)
        want = (ops_kde.gauss_sum_reference(t["x"], t["p"], t["ih"],
                                            t["il2"], t["c"]),)
    elif kind == "vjp":
        g = t["g"] if shared else torch.where(t["tail"], 0.0, t["g"])
        got = ops_kde.gauss_sum_vjp(t["x"], t["p"], t["ih"], t["il2"], g,
                                    n, m)
        want = ops_kde.gauss_sum_vjp_reference(t["x"], t["p"], t["ih"],
                                               t["il2"], g)
    else:
        got = ops_kde.gauss_sum_jvp(t["x"], t["p"], t["ih"], t["dih"],
                                    t["il2"], t["dil2"], t["c"], t["dc"],
                                    n, m)
        want = ops_kde.gauss_sum_jvp_reference(
            t["x"], t["p"], t["ih"], t["dih"], t["il2"], t["dil2"], t["c"],
            t["dc"])
    # outputs past a count are zero; the others equal the dense ones
    if kind == "vjp":
        out_tail = t["tail"]
    else:
        out_tail = t["tail"] if not shared else torch.zeros_like(
            want[0], dtype=torch.bool)
    for gt, wt in zip(got, want):
        mask = out_tail if gt.dim() == 2 else out_tail.unsqueeze(1) \
            .expand_as(gt)
        assert bool((gt[mask] == 0).all())
        assert _rel(gt[~mask].numpy(), wt[~mask].numpy()) <= SELF_RTOL
    # NaN coordinates past a count (padding) reach nothing
    x = t["x"].clone()
    x[t["tail"].unsqueeze(1).expand_as(x)] = float("nan")
    p = t["p"] if shared else x
    if kind == "sum":
        again = (ops_kde.gauss_sum(x, p, t["ih"], t["il2"], t["c"], n, m),)
    elif kind == "vjp":
        again = ops_kde.gauss_sum_vjp(x, p, t["ih"], t["il2"], g, n, m)
    else:
        again = ops_kde.gauss_sum_jvp(x, p, t["ih"], t["dih"], t["il2"],
                                      t["dil2"], t["c"], t["dc"], n, m)
    for a, b in zip(again, got):
        assert torch.equal(a, b)


def test_counts_are_checked_and_bound_the_work():
    t = _kernel_inputs(2, True)
    with pytest.raises(ValueError):
        ops_kde.gauss_sum(t["x"], t["p"], t["ih"], t["il2"], t["c"],
                          t["counts"][:2])
    with pytest.raises(ValueError):
        ops_kde.gauss_sum(t["x"], t["p"], t["ih"], t["il2"], t["c"],
                          t["counts"].double())
    n = [40, 17, 0, 1]
    ops = ops_kde.kde_operations("sum", 4, 2, 40, 25, n)
    assert ops["pairs"] == 58 * 25 and ops["flops"] == 8 * ops["pairs"]
    ops = ops_kde.kde_operations("vjp", 4, 2, 40, 40, n, n)
    assert ops["pairs"] == 40 ** 2 + 17 ** 2 + 1
    live, by = ops_kde.kde_bound_ms("sum", 24, 2, 20000, 20000,
                                    torch.float32, False, [10000] * 24,
                                    [10000] * 24)
    dense, _ = ops_kde.kde_bound_ms("sum", 24, 2, 20000, 20000,
                                    torch.float32, False)
    assert by == "operations" and live == pytest.approx(dense / 4)


# -- the live order ------------------------------------------------------------------
def _binning(b):
    return b.MultiDimBinning([
        b.OneDimBinning("energy", num_bins=5, is_lin=True, domain=[0, 10]),
        b.OneDimBinning("pid", bin_edges=[-1000, 0, 1000]),
        b.OneDimBinning("coszen", num_bins=4, is_lin=True, domain=[-1, 1]),
    ], name="kde_compact")


def _categories(seed=0, sizes=(90, 70, 50), tracks_only=(1,)):
    """(energy, pid, coszen) samples of a few categories with
    make_toy_events' PID rule: the categories in `tracks_only` all tracks
    (pid uniform on [0, 3)), the others about 3/4 cascades (uniform on
    [-3, 1))."""
    rng = np.random.RandomState(seed)
    out = []
    for c, n in enumerate(sizes):
        pid = rng.uniform(0, 3, n) if c in tracks_only else \
            rng.uniform(-3, 1, n)
        out.append(np.stack([rng.uniform(0.5, 9.5, n), pid,
                             rng.uniform(-1, 1, n)], axis=1))
    return out


def _stack(cats, n_pad):
    """(C, n_pad, 3) with NaN padding and the (C, n_pad) real-event mask."""
    sample = np.full((len(cats), n_pad, 3), np.nan)
    real = np.zeros((len(cats), n_pad), dtype=bool)
    for c, s in enumerate(cats):
        sample[c, :len(s)] = s
        real[c, :len(s)] = True
    return sample, real


def test_live_order_comes_from_the_pid_cut_and_the_padding_alone():
    plan = torch_kde.KDEPlan(_binning(torch_binning), device="cpu")
    cats = _categories()
    sample, real = _stack(cats, 100)
    sample, real = torch.as_tensor(sample), torch.as_tensor(real)
    order, counts = plan.live_order(sample, real)
    assert counts.dtype == torch.int32 and counts.shape == (3, 2)
    for c, s in enumerate(cats):
        casc = int((s[:, 1] < 0).sum())
        assert counts[c].tolist() == [casc, len(s) - casc]
        for k, want in enumerate((np.flatnonzero(s[:, 1] < 0),
                                  np.flatnonzero(s[:, 1] >= 0))):
            got = order[c, k, :len(want)].numpy()
            np.testing.assert_array_equal(got, want)  # in their order
        for k in range(2):  # a permutation of every slot
            assert sorted(order[c, k].tolist()) == list(range(100))
    assert counts[1, 0] == 0  # the all-tracks category's cascade channel
    # the weights play no part: a zero-weight live event stays live
    w = torch.ones(3, 100, dtype=torch.float64)
    w[0, :5] = 0.0
    assert torch.equal(plan.live_order(sample, real)[1], counts)
    # without the mask the NaN pid of a padding slot is in no channel
    assert torch.equal(plan.live_order(sample)[1], counts)


# -- maps and gradients against the JAX package ---------------------------------------
def test_kde_histogramdd_with_the_pid_pattern_matches_jax():
    """One category's samples in both channels (its cascade channel
    empty), another's about 3/4 cascades, through kde_histogramdd; and a
    stacked plan of three categories with padding slots and three lanes of
    weights against each lane's and category's own JAX histogram."""
    cats = _categories(1)
    rng = np.random.RandomState(2)
    for s in cats[:2]:
        w = rng.uniform(0.5, 1.5, len(s))
        want = np.asarray(jax_kde.kde_histogramdd(
            s, _binning(jax_binning), weights=w, **PLAN_KW, **KW))
        got = torch_kde.kde_histogramdd(
            s, _binning(torch_binning), weights=w, device="cpu",
            **PLAN_KW, **KW)
        assert np.isfinite(got).all()
        assert _map_rel(np.moveaxis(got, 1, 0), np.moveaxis(want, 1, 0)) \
            <= MAP_TOL
    # stacked: (lanes, categories, n_pad) weights, zeros at the padding
    sample, real = _stack(cats, 100)
    lanes = rng.uniform(0.5, 1.5, (3, 3, 100)) * real
    plan = torch_kde.KDEPlan(_binning(torch_binning), device="cpu",
                             **PLAN_KW)
    got = plan(torch.as_tensor(sample), torch.as_tensor(lanes),
               real=torch.as_tensor(real), **KW).numpy()
    assert got.shape == (3, 3, 5 * 2 * 4) and np.isfinite(got).all()
    for b in range(3):
        for c, s in enumerate(cats):
            want = np.asarray(jax_kde.kde_histogramdd(
                s, _binning(jax_binning), weights=lanes[b, c, :len(s)],
                **PLAN_KW, **KW))
            assert _map_rel(
                np.moveaxis(got[b, c].reshape(5, 2, 4), 1, 0),
                np.moveaxis(want, 1, 0)) <= MAP_TOL, (b, c)


def _weights_of(theta, base, f1, f2, xp):
    return base * xp.exp(theta[0] * f1 + theta[1] * f2)


def test_value_and_grad_with_zero_weight_live_samples_matches_jax():
    """A chi-square of the stacked KDE's maps against data, as a function
    of two parameters that scale the weights, where a tenth of the live
    samples have weight 0 (a normalization at 0): value and gradient
    against jax.value_and_grad of the same function on the JAX package's
    kde_histogramdd, category by category."""
    cats = _categories(3, sizes=(80, 60, 40))
    rng = np.random.RandomState(4)
    sample, real = _stack(cats, 80)
    base = rng.uniform(0.5, 1.5, real.shape) * real
    base[real & (rng.uniform(size=real.shape) < 0.1)] = 0.0
    f1, f2 = rng.normal(size=real.shape), rng.normal(size=real.shape)
    data = rng.uniform(0.5, 2.0, (3, 40)) * 60.0
    theta = np.array([0.3, -0.2])

    plan = torch_kde.KDEPlan(_binning(torch_binning), device="cpu",
                             **PLAN_KW)
    st, rt = torch.as_tensor(sample), torch.as_tensor(real)

    def torch_value(th):
        w = _weights_of(th, *(torch.as_tensor(a) for a in (base, f1, f2)),
                        torch)
        maps = plan(st, w, real=rt, **KW)
        d = torch.as_tensor(data)
        return (torch.square(maps - d) / d).sum()

    th = torch.as_tensor(theta).requires_grad_(True)
    value = torch_value(th)
    (grad,) = torch.autograd.grad(value, th)

    def jax_value(th):
        total = 0.0
        for c, s in enumerate(cats):
            n = len(s)
            w = _weights_of(th, base[c, :n], f1[c, :n], f2[c, :n], jnp)
            h = jax_kde.kde_histogramdd(s, _binning(jax_binning), weights=w,
                                        **PLAN_KW, **KW)
            total = total + jnp.sum(jnp.square(h.reshape(-1) - data[c])
                                    / data[c])
        return total

    want_value, want_grad = jax.value_and_grad(jax_value)(jnp.asarray(theta))
    assert abs(float(value) - float(want_value)) <= VALUE_RTOL * abs(
        float(want_value))
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               rtol=GRAD_RTOL, atol=0)


# -- the density on the compacted layout ------------------------------------------------
def _compact_density_inputs(seed=5, B=3, D=2, N=24, M=7):
    rng = np.random.RandomState(seed)
    counts = torch.tensor([24, 11, 0][:B], dtype=torch.int32)
    tail = torch.arange(N)[None, :] >= counts[:, None].long()
    x = torch.as_tensor(rng.normal(size=(B, D, N)))
    w = torch.as_tensor(rng.uniform(0.5, 2, (B, N))).masked_fill(tail, 0.0)
    w = w / torch.where(w.sum(-1, keepdim=True) > 0,
                        w.sum(-1, keepdim=True), 1.0)
    h = torch.as_tensor(rng.uniform(0.3, 0.6, (B, D)))
    h[2] = 1e-30  # the empty row's clamped bandwidth
    p = torch.as_tensor(rng.normal(size=(D, M)))
    return x, w, h, p, counts, tail


@pytest.mark.parametrize("adaptive", [True, False])
def test_compacted_density_passes_gradcheck(adaptive):
    """The backward of AdaptiveDensity with live counts (the weights past a
    row's count held at 0, as KDEPlan holds them) against finite
    differences."""
    x, w, h, p, counts, tail = _compact_density_inputs()
    w_live = w[:2].clone().requires_grad_(True)
    h_live = h[:2].clone().requires_grad_(True)

    def f(w_, h_):
        wf = torch.cat([w_.masked_fill(tail[:2], 0.0), w[2:]])
        hf = torch.cat([h_, h[2:]])
        return ops_kde.adaptive_density(x, wf, hf, p, adaptive, 0.3, counts)

    assert torch.autograd.gradcheck(f, (w_live, h_live))


def _plain_density(x, p, counts, alpha):
    """The adaptive density of AdaptiveDensity with live counts in plain
    torch ops, every step differentiable by autograd (the pilot
    included)."""
    def f(w, h):
        pilot = torch.ones_like(w)
        q = ops_kde._widths(x, w, h, pilot, False, alpha)
        pilot = ops_kde.gauss_sum_reference(x, x, q["ih"], pilot, q["c0"],
                                            counts, counts)
        q = ops_kde._widths(x, w, h, pilot, True, alpha)
        return ops_kde.gauss_sum_reference(x, p, q["ih"], q["il2"], q["c"],
                                           counts)
    return f


def test_compacted_density_jacfwd_matches_jacrev():
    """jacfwd of AdaptiveDensity with live counts (its forward-mode rule,
    the directions as rows of the jvp launches) against jacrev of the same
    density in plain torch ops, in the live rows' weights and the
    bandwidths."""
    x, w, h, p, counts, tail = _compact_density_inputs(6)
    live = torch.arange(2)

    def f(w_, h_):
        wf = torch.cat([w_.masked_fill(tail[live], 0.0), w[2:]])
        return ops_kde.adaptive_density(x, wf, torch.cat([h_, h[2:]]), p,
                                        True, 0.3, counts)

    plain = _plain_density(x, p, counts, 0.3)

    def g(w_, h_):
        wf = torch.cat([w_.masked_fill(tail[live], 0.0), w[2:]])
        return plain(wf, torch.cat([h_, h[2:]]))

    fw, fh = torch.func.jacfwd(f, argnums=(0, 1))(w[live], h[live])
    rw, rh = torch.func.jacrev(g, argnums=(0, 1))(w[live], h[live])
    for a, b in ((fw, rw), (fh, rh)):
        assert torch.isfinite(a).all() and torch.isfinite(b).all()
        assert _rel(a.numpy(), b.numpy()) <= FWD_RTOL
    # the empty row and the masked tails take no derivative
    assert bool((fw[2] == 0).all())
    assert bool((fw[..., tail[live]] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_empty_and_one_sample_channels_stay_finite(dtype):
    """A category whose cascade channel is empty and one whose cascade
    channel holds one event (bandwidth clamped to 1e-30 in both): finite
    maps, zeros in the empty channel, finite gradients of the weights and
    finite forward-mode tangents."""
    rng = np.random.RandomState(7)
    cats = _categories(8, sizes=(60, 50), tracks_only=(0, 1))
    cats[1][0, 1] = -0.5  # one cascade
    sample, real = _stack(cats, 60)
    plan = torch_kde.KDEPlan(_binning(torch_binning), device="cpu",
                             dtype=dtype, **PLAN_KW)
    st = torch.as_tensor(sample, dtype=dtype)
    rt = torch.as_tensor(real)
    w = torch.as_tensor(rng.uniform(0.5, 1.5, real.shape) * real,
                        dtype=dtype).requires_grad_(True)
    maps = plan(st, w, real=rt, **KW)
    assert torch.isfinite(maps).all()
    assert bool((maps.reshape(2, 5, 2, 4)[0, :, 0] == 0).all())
    weight = torch.arange(maps.numel(), dtype=dtype).reshape(maps.shape)
    (grad,) = torch.autograd.grad((maps * weight).sum(), w)
    assert torch.isfinite(grad).all()
    assert bool((grad[~rt] == 0).all())  # the padding takes no gradient
    dw = torch.as_tensor(rng.normal(size=real.shape), dtype=dtype)
    _, tangent = torch.func.jvp(
        lambda w_: plan(st, w_, real=rt, **KW), (w.detach(),), (dw,))
    assert torch.isfinite(tangent).all()
