"""
The direction axis of the KDE's forward mode, in fp64 on the CPU (conftest),
where ``kde_gauss_sum_jvp`` runs as its plain version
(``pisa_tpu_torch/ops/kde.py:gauss_sum_jvp_reference``):

- the plain version with K directions against K single-direction calls, at
  D = 1..3, shared and per-row points, with and without live counts, at K =
  1, 3 and 8;
- the wrapper's checks of the direction axis (at most ``MAX_DIRECTIONS`` a
  launch);
- ``torch.func.jacfwd`` of the adaptive density hands its directions to the
  jvp in chunks of at most six (recorded through a wrapped
  ``gauss_sum_jvp``) and matches ``torch.func.jacrev`` of the same density
  in plain torch ops; a vmap over lanes of a ``jvp`` still folds the lanes
  into the batch, and a vmap over lanes of a ``jacfwd`` gives each lane its
  own Jacobian;
- a sample whose c is 0 adds k dc alone in the plain version, as the
  kernel stages it: at the card test's inputs each direction equals the
  earlier single-direction plain version bit for bit, and the two differ only
  where the earlier one is NaN (0 times an infinite width tangent);
- on a card (``cuda`` marker; skipped without one): the kernel at K = 1..6
  against the plain version, dense with a zero-weight channel and with live
  counts, at the wrapper's split count and at one split.

Tolerances: the K-direction plain version against single calls 1e-12
relative of the largest entry (the same terms summed over the same axis);
jacfwd against jacrev 1e-10 (the density's own, ``test_torch_kde.py``); the
card's float64 kernel 1e-12 and float32 1e-4 of the largest entry (the
sums' round-off in float32).
"""

import numpy as np
import pytest
import torch

from pisa_tpu_torch.ops import kde as ops_kde

PLAIN_RTOL = 1e-12
DENSITY_RTOL = 1e-10
CARD_RTOL = {torch.float64: 1e-12, torch.float32: 1e-4}


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
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.abs(want).max()


def _inputs(dims, shared, live, K, seed=11, B=4, N=50, M=33):
    """x (B, D, N), points, ih, il2, c, the live counts (None or (B,)) and
    K directions (dih (K, B, D), dil2 and dc (K, B, N)). Row 1 is a
    zero-weight channel (ih 1e30, c 0); with `live` the first four rows
    hold N, 21, 0 and 1 live samples (any further row N // 2), and the
    samples past them NaN coordinates and no weight."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(B, dims, N))
    p = rng.normal(size=(dims, M)) if shared else rng.normal(
        size=(B, dims, M))
    ih = rng.uniform(1.0, 3.0, (B, dims))
    il2 = rng.uniform(0.5, 2.0, (B, N))
    c = rng.uniform(0.0, 1.0, (B, N))
    ih[1] = 1e30
    c[1] = 0.0
    counts = None
    if live:
        n_live = np.array([N, 21, 0, 1] + [N // 2] * (B - 4))
        tail = np.arange(N)[None, :] >= n_live[:, None]
        c[tail] = 0.0
        x[np.broadcast_to(tail[:, None, :], x.shape)] = np.nan
        counts = torch.as_tensor(n_live, dtype=torch.int32)
    dih = rng.normal(size=(K, B, dims))
    dih[:, 1] = 0.0  # a clamped bandwidth has no tangent
    t = [torch.as_tensor(a) for a in (x, p, ih, il2, c)]
    d = [torch.as_tensor(a) for a in (dih, rng.normal(size=(K, B, N)),
                                      rng.normal(size=(K, B, N)))]
    return t, d, counts


@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("dims", [1, 2, 3])
def test_directions_plain_version_equals_single_calls(dims, shared, live, K):
    (x, p, ih, il2, c), (dih, dil2, dc), n = _inputs(dims, shared, live, K)
    m = None if shared else n
    out, dout = ops_kde.gauss_sum_jvp_reference(x, p, ih, dih, il2, dil2, c,
                                                dc, n, m)
    assert dout.shape == (K,) + tuple(out.shape)
    assert torch.isfinite(out).all() and torch.isfinite(dout).all()
    for k in range(K):
        one, done = ops_kde.gauss_sum_jvp_reference(x, p, ih, dih[k], il2,
                                                    dil2[k], c, dc[k], n, m)
        np.testing.assert_array_equal(out.numpy(), one.numpy())
        assert _rel(dout[k].numpy(), done.numpy()) <= PLAIN_RTOL
    # the zero-weight channel's value and tangents are 0
    assert bool((out[1] == 0).all()) and bool((dout[:, 1] == 0).all())


def test_wrapper_takes_and_checks_directions():
    (x, p, ih, il2, c), (dih, dil2, dc), _ = _inputs(2, True, False, 8)
    before = ops_kde.jvp_launch_count
    out, dout = ops_kde.gauss_sum_jvp(x, p, ih, dih[:6], il2, dil2[:6], c,
                                      dc[:6])
    assert ops_kde.jvp_launch_count == before  # the CPU runs no kernel
    want = ops_kde.gauss_sum_jvp_reference(x, p, ih, dih[:6], il2,
                                           dil2[:6], c, dc[:6])
    np.testing.assert_array_equal(dout.numpy(), want[1].numpy())
    with pytest.raises(ValueError, match="at most 6 directions"):
        ops_kde.gauss_sum_jvp(x, p, ih, dih, il2, dil2, c, dc)
    with pytest.raises(ValueError, match="dil2"):
        ops_kde.gauss_sum_jvp(x, p, ih, dih[:3], il2, dil2[:2], c, dc[:3])
    with pytest.raises(ValueError, match="dc"):
        ops_kde.gauss_sum_jvp(x, p, ih, dih[:3], il2, dil2[:3], c, dc[0])
    with pytest.raises(ValueError, match="no direction"):
        ops_kde.gauss_sum_jvp(x, p, ih, dih[:0], il2, dil2[:0], c, dc[:0])
    # the bound counts K directions' operations: 4D + 2 + K (2D + 2) a pair
    three, by = ops_kde.kde_bound_ms("jvp", 24, 2, 20000, 1320,
                                     torch.float32, directions=3)
    assert by == "operations" and three == pytest.approx(
        24 * 20000 * 1320 * 28 / ops_kde.FP32_FLOPS * 1e3)


def _density_case(seed=5, B=3, D=2, N=30, M=20, n_params=8):
    """Samples, points, weights and bandwidths of B channels driven by
    `n_params` parameters theta: w = w0 (1 + A theta), h = h0 exp(C theta),
    so that a jacfwd over theta has `n_params` directions."""
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.normal(size=(B, D, N)))
    p = torch.as_tensor(rng.normal(size=(D, M)))
    w0 = torch.as_tensor(rng.uniform(0.2, 1.0, (B, N)))
    w0 = w0 / w0.sum(-1, keepdim=True)
    h0 = torch.as_tensor(rng.uniform(0.3, 0.8, (B, D)))
    A = torch.as_tensor(rng.normal(scale=0.2, size=(B, N, n_params)))
    C = torch.as_tensor(rng.normal(scale=0.2, size=(B, D, n_params)))
    theta = torch.as_tensor(rng.normal(scale=0.1, size=n_params))

    def wh(t):
        return w0 * (1.0 + A @ t), h0 * torch.exp(C @ t)
    return x, p, wh, theta


def _plain_density(x, p, adaptive, alpha):
    """AdaptiveDensity's density in plain torch ops, every step
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


def _recording(monkeypatch):
    """Wrap gauss_sum_jvp to record the shape of each call's dih."""
    shapes = []
    inner = ops_kde.gauss_sum_jvp

    def recorded(x, p, ih, dih, *args, **kwargs):
        shapes.append(tuple(dih.shape))
        return inner(x, p, ih, dih, *args, **kwargs)
    monkeypatch.setattr(ops_kde, "gauss_sum_jvp", recorded)
    return shapes


@pytest.mark.parametrize("n_params", [3, 8])
@pytest.mark.parametrize("adaptive", [True, False])
def test_jacfwd_hands_directions_in_chunks_of_six(monkeypatch, adaptive,
                                                  n_params):
    x, p, wh, theta = _density_case(n_params=n_params)
    B, D = x.shape[:2]
    shapes = _recording(monkeypatch)

    def f(t):
        return ops_kde.adaptive_density(x, *wh(t), p, adaptive, 0.3)

    got = torch.func.jacfwd(f)(theta)
    plain = _plain_density(x, p, adaptive, 0.3)
    want = torch.func.jacrev(lambda t: plain(*wh(t)))(theta)
    assert _rel(got.numpy(), want.numpy()) <= DENSITY_RTOL
    chunks = [min(6, n_params - k0) for k0 in range(0, n_params, 6)]
    per_chunk = 2 if adaptive else 1
    assert shapes == [(k, B, D) for k in chunks for _ in range(per_chunk)]


def test_lanes_of_a_jvp_fold_into_the_batch(monkeypatch):
    """vmap over lanes of a jvp (the primals batched): the lanes fold into
    the rows of one call a pass, with its one direction, and each lane
    equals its own jvp."""
    x, p, wh, theta = _density_case(n_params=3)
    B, D = x.shape[:2]
    thetas = torch.stack([theta, -theta, 0.5 * theta])
    dthetas = torch.as_tensor(np.random.RandomState(3).normal(size=(3, 3)))

    def tangent(t, dt):
        return torch.func.jvp(
            lambda a: ops_kde.adaptive_density(x, *wh(a), p, True, 0.3),
            (t,), (dt,))[1]

    shapes = _recording(monkeypatch)
    lanes = torch.func.vmap(tangent)(thetas, dthetas)
    assert shapes == [(1, 3 * B, D), (1, 3 * B, D)]
    for i in range(3):
        assert _rel(lanes[i].numpy(), tangent(thetas[i], dthetas[i]).numpy()) \
            <= DENSITY_RTOL


def test_lanes_of_a_jacfwd_keep_the_direction_axis(monkeypatch):
    """vmap over lanes of a jacfwd: the directions stay the direction axis,
    the lanes join the batch, and each lane equals its own jacfwd."""
    x, p, wh, theta = _density_case(n_params=3)
    B, D = x.shape[:2]
    thetas = torch.stack([theta, 2.0 * theta])

    def jac(t):
        return torch.func.jacfwd(
            lambda a: ops_kde.adaptive_density(x, *wh(a), p, True, 0.3))(t)

    shapes = _recording(monkeypatch)
    lanes = torch.func.vmap(jac)(thetas)
    assert shapes == [(3, 2 * B, D), (3, 2 * B, D)]
    for i in range(2):
        assert _rel(lanes[i].numpy(), jac(thetas[i]).numpy()) <= DENSITY_RTOL


def _earlier_plain_jvp(x, p, ih, dih, il2, dil2, c, dc, n_live, m_live):
    """The single-direction plain version as it stood before the direction
    axis: a sample whose c is 0 still adds k (dc + 0 * (...))."""
    B, D, N = x.shape
    xs, chunks = ops_kde._point_chunks(x, p, ih, B * N * D)
    nl = ops_kde._neg_half_widths(il2)
    ndl = (-0.5 * dil2).unsqueeze(-1)
    r = (2.0 * dih / ih)[:, :, None, None]
    c1, dc1 = c.unsqueeze(-1), dc.unsqueeze(-1)
    ok_i = ops_kde._live_mask(n_live, B, N, x.device)
    M = p.shape[-1]
    dout = torch.empty((B, M), dtype=x.dtype)
    for sl, ps in chunks:
        u2 = torch.square(ps - xs)
        z = u2.sum(1)
        k = torch.exp(nl * z)
        term = dc1 + c1 * (ndl * z + nl * (r * u2).sum(1))
        keep = k != 0
        if ok_i is not None:
            keep = keep & ok_i.unsqueeze(-1)
        dout[:, sl] = torch.where(keep, k * term, 0.0).sum(1)
    ok_j = ops_kde._live_mask(m_live, B, M, x.device)
    return dout if ok_j is None else torch.where(ok_j, dout, 0.0)


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("shared", [True, False])
def test_weightless_samples_leave_every_finite_result_as_it_was(shared, live):
    """The plain version stages a sample whose c is 0 as adding k dc alone,
    as the kernel does. At the card test's inputs (a zero-weight channel,
    live counts, B = 5, N = 700, M = 600) each of six directions, called
    alone, equals the earlier single-direction plain version bit for bit
    (the K-direction call equals single calls to PLAIN_RTOL, above)."""
    K = ops_kde.MAX_DIRECTIONS
    (x, p, ih, il2, c), (dih, dil2, dc), n = _inputs(2, shared, live, K, B=5,
                                                     N=700, M=600)
    m = None if shared else n
    for k in range(K):
        _, dout = ops_kde.gauss_sum_jvp_reference(x, p, ih, dih[k], il2,
                                                  dil2[k], c, dc[k], n, m)
        old = _earlier_plain_jvp(x, p, ih, dih[k], il2, dil2[k], c, dc[k], n,
                                 m)
        assert torch.isfinite(old).all()
        assert torch.equal(dout, old)


def test_weightless_samples_differ_only_where_the_earlier_version_is_nan():
    """With an infinite width tangent at weightless samples, the earlier
    plain version gives 0 * inf = NaN at the points they reach; the plain
    version gives k dc there, and equals it everywhere else."""
    (x, p, ih, il2, c), (dih, dil2, dc), _ = _inputs(2, True, False, 1)
    weightless = c == 0
    weightless[0, :5] = True
    c = torch.where(weightless, 0.0, c)
    dil2 = torch.where(weightless, torch.inf, dil2)
    _, dout = ops_kde.gauss_sum_jvp_reference(x, p, ih, dih[0], il2, dil2[0],
                                              c, dc[0])
    old = _earlier_plain_jvp(x, p, ih, dih[0], il2, dil2[0], c, dc[0], None,
                             None)
    assert torch.isfinite(dout).all()
    nan = torch.isnan(old)
    assert nan[0].all() and not nan[2:].any()
    assert torch.equal(dout[~nan], old[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1])
@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_directions_kernel_matches_plain_version_on_card(cuda_device, dtype,
                                                         live, splits):
    for K in range(1, ops_kde.MAX_DIRECTIONS + 1):
        for shared in (True, False):
            (x, p, ih, il2, c), (dih, dil2, dc), n = _inputs(2, shared, live,
                                                             K, B=5, N=700,
                                                             M=600)
            m = None if shared else n
            want = ops_kde.gauss_sum_jvp_reference(x, p, ih, dih, il2, dil2,
                                                   c, dc, n, m)
            dev = [t.to(cuda_device, dtype) for t in (x, p, ih, dih, il2,
                                                      dil2, c, dc)]
            counts = [None if t is None else t.to(cuda_device)
                      for t in (n, m)]
            before = ops_kde.jvp_launch_count
            got = ops_kde.gauss_sum_jvp(*dev, *counts, splits=splits)
            torch.cuda.synchronize()
            assert ops_kde.jvp_launch_count == before + 1
            for a, b in zip(got, want):
                assert a.shape == b.shape and torch.isfinite(a).all()
                assert _rel(a.double().cpu().numpy(), b.numpy()) \
                    <= CARD_RTOL[dtype]
            assert bool((got[1][:, 1] == 0).all())
