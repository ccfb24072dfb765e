"""
Weighted sums of Gaussian kernels, the inner loop of the adaptive KDE
(``utils/kde.py``), on a hand-written CUDA kernel pair.

The JAX package evaluates the density as one dense (N samples x M points)
XLA contraction (``pisa_tpu/utils/kde.py:101-115``, ``density_at``); at the
KDE stage's 20,000 events per category and PID channel the pilot's (N, N)
intermediate alone is 1.6 GB in float32, and autograd would keep several.
``pisa_tpu_torch/csrc/kde_gauss.cu`` keeps every pair in registers (not a
port of a Pallas kernel; the source says what bounds it):

- :func:`gauss_sum`: ``out[b, j] = sum_i c[b,i] exp(-1/2 il2[b,i] z_ij)``,
  ``z_ij = sum_d ((p[d,j] - x[b,d,i]) ih[b,d])^2``;
- :func:`gauss_sum_vjp`: for a cotangent g (B, M), ``A[b,i] = sum_j g k_ij``
  and ``C[b,d,i] = sum_j g k_ij u_dij^2`` (u the scaled difference), from
  which torch ops form the gradients of c, lambda and h;
- :func:`gauss_sum_jvp`: the sum and its tangents along K directions
  (dih, dil2, dc) in one pass, ``dout[k,b,j] = sum_i k_ij (dc_ki - 1/2 c_i
  (dil2_ki z_ij + il2_i dz_kij))``, ``dz_kij = sum_d 2 ih_d dih_kd (p_dj -
  x_di)^2``; the directions share each pair's distance and exponential.

Live counts: every function takes ``n_live`` and ``m_live`` (B,) integer
tensors on the inputs' device, or None (all N, all M). Row b then sums over
its first ``n_live[b]`` samples and first ``m_live[b]`` points only, and its
outputs past them are zeros. :class:`AdaptiveDensity` takes one ``counts``
for its samples (the pilot's points are its samples); ``utils/kde.py``
orders each PID channel's own samples first, so the pairs that the dense
sum multiplied by a zero weight are never visited.

All three are register-tiled (each thread owns R outputs and one staged
entry of whole 16-byte words serves R pairs), take the float32
exponential on MUFU as ``ex2.approx`` of an exponent that carries log2(e),
and cut their inner side over ``splits`` blocks where the outer side is
too short to fill the card, with a fixed-order second pass
(:func:`launch_splits`). The sum is bounded by MUFU, the vjp and the jvp by
dispatching their FMA-pipe instructions (the source note has the counts).
On an H100 in float32 at kde_example's 24 x 20,000 samples the pilot's sum
runs at 81% of its bound dense and 74% on the live pairs, its vjp at 56%
and 52% (``chip_smoke.py:kde_vs_plain``), the jvp on the live pairs at 47%
for a Fisher matrix's 3 directions and 43% for one
(``chip_smoke.py:kde_jvp_vs_plain``).

CPU tensors go through the plain versions (:func:`gauss_sum_reference`,
:func:`gauss_sum_vjp_reference`, :func:`gauss_sum_jvp_reference`, chunked
over the points so that their memory stays bounded, with the same live
counts); CUDA tensors launch the kernel or raise. Each wrapper counts its
launches (:data:`sum_launch_count`, :data:`vjp_launch_count`,
:data:`jvp_launch_count`).

:class:`AdaptiveDensity` is the whole density of
``adaptive_gaussian_kde`` (the pilot at the samples, its geometric mean,
the local widths lambda, the norms and the sum at the points) as one
``torch.autograd.Function`` around the kernels: backward by hand (two vjp
launches with the pilot, one without), forward mode by hand (two jvp
launches with the pilot, one without; the directions of a
``torch.func.jacfwd`` go to the same launches as the kernel's direction
axis, in chunks of :data:`MAX_DIRECTIONS`), and a vmap rule that folds the
vmapped axis into the batch.

:func:`kde_operations` and :func:`kde_bound_ms` count the work (of the live
pairs, where counts are given) and give the least time an H100 could take
for it.
"""

from __future__ import annotations

import ctypes
import math
import os
import types

import torch

__all__ = [
    "gauss_sum",
    "gauss_sum_vjp",
    "gauss_sum_reference",
    "gauss_sum_vjp_reference",
    "gauss_sum_jvp",
    "gauss_sum_jvp_reference",
    "AdaptiveDensity",
    "adaptive_density",
    "kde_operations",
    "kde_bound_ms",
    "kernel_library",
    "kernel_attributes",
    "launch_splits",
    "sum_launch_count",
    "vjp_launch_count",
    "jvp_launch_count",
    "MAX_DIMS",
    "MAX_DIRECTIONS",
]

#: the kernels' largest number of dimensions
MAX_DIMS = 3
#: the most directions one ``kde_gauss_sum_jvp`` launch takes (its
#: templates K = 1..6); :class:`AdaptiveDensity`'s forward mode cuts more
#: into chunks of this many
MAX_DIRECTIONS = 6

#: launches of ``kde_gauss_sum`` / ``kde_gauss_sum_vjp`` /
#: ``kde_gauss_sum_jvp`` made in this process by :func:`gauss_sum` /
#: :func:`gauss_sum_vjp` / :func:`gauss_sum_jvp` (incremented where the
#: kernel is launched, and nowhere else; a split launch with its second
#: pass counts once)
sum_launch_count = 0
vjp_launch_count = 0
jvp_launch_count = 0

#: the plain versions' largest (B, N, points) intermediate, in elements
_CHUNK_ELEMS = 1 << 24

#: a split launch aims at this many waves of the card's resident blocks
_WAVES = 8
#: and gives each split at least this many staged tiles of the inner side:
#: the vjp's second pass reads 1 + D values a sample and split, and at the
#: grid's 1,320 points 10 splits took 11-13% longer than 5
#: (scripts/tune_kde.py on an H100)
_MIN_TILES = {"sum": 1, "vjp": 2, "jvp": 1}

_CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc",
    "kde_gauss.cu",
)
_LIB = None
_ATTRS = {}
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# -- H100 SXM peaks, for the bound (NVIDIA's data sheet, dense, 700 W) --------
#: float32 outside the tensor cores, FLOP/s (an FMA counts two)
FP32_FLOPS = 67e12
#: float64 outside the tensor cores, FLOP/s
FP64_FLOPS = 34e12
#: MUFU.EX2 results per second: 16 a clock per SM (CUDA C programming guide,
#: arithmetic instruction throughput, compute capability 9.0) x 132 SMs x
#: the 1.98 GHz boost clock
MUFU_EXP_PER_S = 16 * 132 * 1.98e9
#: device memory, bytes/s
HBM_BYTES_PER_S = 3.35e12


def _row_counts(counts, batch, full):
    """Each row's live count as host ints: `full` for every row where
    `counts` is None, else `counts` (a (batch,) tensor or sequence) clipped
    to [0, full] as the kernels clip it."""
    if counts is None:
        return [int(full)] * int(batch)
    if isinstance(counts, torch.Tensor):
        counts = counts.detach().cpu().reshape(-1).tolist()
    counts = [min(max(int(c), 0), int(full)) for c in counts]
    if len(counts) != int(batch):
        raise ValueError(f"{len(counts)} counts for {batch} rows")
    return counts


def kde_operations(kind, batch, dims, n, m, n_live=None, m_live=None,
                   directions=1):
    """The work of one launch: ``{"pairs", "flops", "exps"}`` for `kind`
    "sum" (3D + 2 operations and one exp a pair: D subtractions, D squares
    and D - 1 additions, the width's multiply, the weight's multiply-add),
    "vjp" (5D + 2: the same distance, g k, the sum A and D multiply-adds
    for C) or "jvp" with K `directions` (4D + 2 + K (2D + 2): the sum's 3D
    + 2, the D products k u_d^2, and for each direction a multiply-add of
    dc and D of the staged G; ``csrc/kde_gauss.cu``). With live counts
    (each row's, as the kernels take them; None: all) only the live pairs
    count."""
    nl = _row_counts(n_live, batch, n)
    ml = _row_counts(m_live, batch, m)
    pairs = sum(a * b for a, b in zip(nl, ml))
    per = {"sum": 3 * dims + 2, "vjp": 5 * dims + 2,
           "jvp": 4 * dims + 2 + int(directions) * (2 * dims + 2)}[kind]
    return {"pairs": pairs, "flops": pairs * per, "exps": pairs}


def kde_bound_ms(kind, batch, dims, n, m, dtype, shared_points=True,
                 n_live=None, m_live=None, directions=1):
    """(least milliseconds an H100 SXM could take, "operations" or "bytes")
    for one launch: the larger of the bytes (each live input read once,
    each output written once, over :data:`HBM_BYTES_PER_S`; the jvp's K
    `directions` read K tangent sets and write K tangents) and the
    operations of :func:`kde_operations` (the live pairs where counts are
    given). In float32 the operations' time is the larger of the FMA pipe's
    (:data:`FP32_FLOPS`) and the exps' on the special-function unit
    (:data:`MUFU_EXP_PER_S`); in float64 every operation, the exp counted as
    one, runs on the FMA pipe (:data:`FP64_FLOPS`)."""
    ops = kde_operations(kind, batch, dims, n, m, n_live, m_live, directions)
    item = torch.finfo(dtype).bits // 8
    sn = sum(_row_counts(n_live, batch, n))
    sm = sum(_row_counts(m_live, batch, m))
    points = dims * (m if shared_points else sm)
    K = int(directions)
    if kind == "sum":
        values = dims * sn + points + batch * dims + 2 * sn + batch * m
    elif kind == "jvp":
        values = dims * sn + points + (1 + K) * batch * dims \
            + (2 + 2 * K) * sn + (1 + K) * batch * m
    else:
        values = dims * sn + points + batch * dims + sn + sm \
            + batch * n * (1 + dims)
    t_bytes = values * item / HBM_BYTES_PER_S
    if dtype == torch.float64:
        t_ops = (ops["flops"] + ops["exps"]) / FP64_FLOPS
    else:
        t_ops = max(ops["flops"] / FP32_FLOPS, ops["exps"] / MUFU_EXP_PER_S)
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


# -- the kernels ----------------------------------------------------------------
def kernel_library():
    """The kernels' entry points, built from ``csrc/kde_gauss.cu`` at first
    use (``utils/cuda_build.py``)."""
    global _LIB
    if _LIB is None:
        from pisa_tpu_torch.utils.cuda_build import build_libraries

        lib = build_libraries({"kde_gauss": ([_CSRC], [])})["kde_gauss"]
        _LIB = bind_library(lib)
    return _LIB


def bind_library(lib):
    """The entry points of a loaded ``kde_gauss`` library (a ctypes.CDLL),
    with their argument types, as a namespace."""
    fns = {}
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"kde_gauss_sum_{suffix}")
        fn.argtypes = [_P, _P, _LL] + [_P] * 7 + [_I] * 5 + [_P]
        fn.restype = _I
        fns[f"sum_{suffix}"] = fn
        fn = getattr(lib, f"kde_gauss_sum_vjp_{suffix}")
        fn.argtypes = [_P, _P, _LL] + [_P] * 8 + [_I] * 5 + [_P]
        fn.restype = _I
        fns[f"vjp_{suffix}"] = fn
        fn = getattr(lib, f"kde_gauss_sum_jvp_{suffix}")
        fn.argtypes = [_P, _P, _LL] + [_P] * 11 + [_I] * 6 + [_P]
        fn.restype = _I
        fns[f"jvp_{suffix}"] = fn
        fn = getattr(lib, f"kde_gauss_attributes_{suffix}")
        fn.argtypes = [_I, _I, _I, _P]
        fn.restype = _I
        fns[f"attributes_{suffix}"] = fn
    return types.SimpleNamespace(**fns)


def kernel_attributes(kind, dims, dtype, lib=None, directions=1):
    """Registers per thread, local bytes per thread, shared bytes per block,
    threads per block, resident blocks per SM, outputs per thread and the
    card's SMs of the `kind` ("sum", "vjp" or "jvp", the latter at K
    `directions`) kernel at `dims` in `dtype`, on the current card (of
    `lib`, a :func:`bind_library` namespace, else of
    :func:`kernel_library`; cached per card)."""
    lib = kernel_library() if lib is None else lib
    suffix = "f64" if dtype == torch.float64 else "f32"
    directions = int(directions) if kind == "jvp" else 1
    key = (id(lib), kind, int(dims), directions, suffix,
           torch.cuda.current_device())
    if key not in _ATTRS:
        info = (ctypes.c_int * 7)()
        rc = getattr(lib, f"attributes_{suffix}")(
            {"sum": 0, "vjp": 1, "jvp": 2}[kind], int(dims), directions,
            ctypes.addressof(info))
        if rc != 0:
            raise RuntimeError(f"kde_gauss attributes: CUDA error {rc}")
        keys = ("registers", "local_bytes", "shared_bytes", "threads",
                "blocks_per_sm", "outputs_per_thread", "sms")
        _ATTRS[key] = dict(zip(keys, info))
    return dict(_ATTRS[key])


def launch_splits(kind, dims, dtype, batch, outer, inner, lib=None,
                  directions=1):
    """How many blocks the inner side of a `kind` ("sum", "vjp" or "jvp")
    launch is cut over, from the shapes alone (no count is read): enough
    for :data:`_WAVES` waves of the card's resident blocks where the outer
    side (points for the sum and the jvp, samples for the vjp) gives fewer,
    and no split below :data:`_MIN_TILES` staged tiles of the inner side
    (the numbers of ``scripts/tune_kde.py`` on an H100)."""
    a = kernel_attributes(kind, dims, dtype, lib, directions)
    tile = a["threads"] * a["outputs_per_thread"]
    blocks = max(1, -(-int(outer) // tile) * int(batch))
    want = -(-(_WAVES * a["sms"] * max(1, a["blocks_per_sm"])) // blocks)
    most = max(1, int(inner) // (a["threads"] * _MIN_TILES[kind]))
    return max(1, min(want, most))


def _check(x, p, ih, il2, last, last_len):
    """Shapes and types shared by both wrappers: x (B, D, N), p (D, M) or
    (B, D, M), ih (B, D), il2 (B, N), `last` (B, last_len)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, D, N); got {tuple(x.shape)}")
    B, D, N = x.shape
    if not 1 <= D <= MAX_DIMS:
        raise ValueError(f"the kernels take 1 to {MAX_DIMS} dimensions, not"
                         f" {D}")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernels take float32 or float64, not"
                         f" {x.dtype}")
    if p.dim() == 2:
        if p.shape[0] != D:
            raise ValueError(f"points {tuple(p.shape)} for {D} dimensions")
    elif p.dim() != 3 or p.shape[:2] != (B, D):
        raise ValueError(f"points must be (D, M) or (B, D, M); got"
                         f" {tuple(p.shape)} for x {tuple(x.shape)}")
    for name, t, shape in (("ih", ih, (B, D)), ("il2", il2, (B, N)),
                           ("c/g", last, (B, last_len))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
    for t in (p, ih, il2, last):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError("every input must share x's type and device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if B > 65535 or N > 2**31 - 1 or p.shape[-1] > 2**31 - 1:
        raise ValueError(f"too large for one launch: B {B}, N {N},"
                         f" M {p.shape[-1]}")
    return B, D, N, p.shape[-1]


def _check_counts(x, *counts):
    """The live counts: each None or a (B,) integer tensor on x's
    device."""
    for t in counts:
        if t is None:
            continue
        if tuple(t.shape) != (x.shape[0],) or t.dtype.is_floating_point \
                or t.dtype == torch.bool or t.device != x.device:
            raise ValueError(f"live counts must be ({x.shape[0]},) integers"
                             f" on {x.device}; got {tuple(t.shape)}"
                             f" {t.dtype} on {t.device}")


def _live_mask(counts, B, L, device):
    """(B, L) bool: index < counts[b]; None without counts."""
    if counts is None:
        return None
    return torch.arange(L, device=device) < counts.to(torch.int64)[:, None]


def _point_chunks(x, p, ih, n_batch_elems):
    """(scaled samples (B, D, N, 1), [(slice, scaled points (B, D, 1, m))]):
    the points cut so that a (B, N, m) block has at most _CHUNK_ELEMS
    elements."""
    B, D, N = x.shape
    M = p.shape[-1]
    ps = p if p.dim() == 3 else p.unsqueeze(0)
    step = max(1, _CHUNK_ELEMS // max(1, n_batch_elems))
    xs = (x * ih[:, :, None]).unsqueeze(-1)
    chunks = []
    for j0 in range(0, M, step):
        sl = slice(j0, min(M, j0 + step))
        chunks.append((sl, (ps[..., sl] * ih[:, :, None]).unsqueeze(-2)))
    return xs, chunks


def _neg_half_widths(il2):
    """-1/2 il2 (B, N, 1), il2 floored at its type's smallest normal number
    as the kernels stage it: a zero-weight channel's widths may underflow to
    0 beside distances that overflow, and the exponent 0 * inf would be NaN
    where exp(-inf) = 0 is meant."""
    return (-0.5 * torch.clamp(il2, min=torch.finfo(il2.dtype).tiny)) \
        .unsqueeze(-1)


def gauss_sum_reference(x, p, ih, il2, c, n_live=None, m_live=None):
    """The plain version of :func:`gauss_sum`, in the kernel's arithmetic
    (samples and points scaled by ih first), chunked over the points; the
    samples past ``n_live`` left out, the points past ``m_live`` zero."""
    B, D, N, M = _check(x, p, ih, il2, c, x.shape[-1])
    _check_counts(x, n_live, m_live)
    xs, chunks = _point_chunks(x, p, ih, B * N)
    nl = _neg_half_widths(il2)
    ok_i = _live_mask(n_live, B, N, x.device)
    out = torch.empty((B, M), dtype=x.dtype, device=x.device)
    for sl, ps in chunks:
        z = torch.square(ps - xs).sum(1)  # (B, N, m)
        terms = c.unsqueeze(-1) * torch.exp(nl * z)
        if ok_i is not None:
            terms = torch.where(ok_i.unsqueeze(-1), terms, 0.0)
        out[:, sl] = terms.sum(1)
    ok_j = _live_mask(m_live, B, M, x.device)
    return out if ok_j is None else torch.where(ok_j, out, 0.0)


def gauss_sum_vjp_reference(x, p, ih, il2, g, n_live=None, m_live=None):
    """The plain version of :func:`gauss_sum_vjp`: (A (B, N), C (B, D, N)),
    terms with k = 0 left out as the kernel leaves them out, the points past
    ``m_live`` left out, the samples past ``n_live`` zero."""
    B, D, N, M = _check(x, p, ih, il2, g, p.shape[-1])
    _check_counts(x, n_live, m_live)
    xs, chunks = _point_chunks(x, p, ih, B * N * D)
    nl = _neg_half_widths(il2)
    ok_j = _live_mask(m_live, B, M, x.device)
    A = torch.zeros((B, N), dtype=x.dtype, device=x.device)
    C = torch.zeros((B, D, N), dtype=x.dtype, device=x.device)
    for sl, ps in chunks:
        u2 = torch.square(ps - xs)  # (B, D, N, m)
        k = torch.exp(nl * u2.sum(1))  # (B, N, m)
        gk = g[:, None, sl] * k
        keep = k != 0
        if ok_j is not None:
            gk = torch.where(ok_j[:, None, sl], gk, 0.0)
            keep = keep & ok_j[:, None, sl]
        A += gk.sum(-1)
        C += torch.where(keep.unsqueeze(1), gk.unsqueeze(1) * u2,
                         0.0).sum(-1)
    ok_i = _live_mask(n_live, B, N, x.device)
    if ok_i is not None:
        A = torch.where(ok_i, A, 0.0)
        C = torch.where(ok_i.unsqueeze(1), C, 0.0)
    return A, C


def gauss_sum_jvp_reference(x, p, ih, dih, il2, dil2, c, dc, n_live=None,
                            m_live=None):
    """The plain version of :func:`gauss_sum_jvp`, in the kernel's
    arithmetic (dz from the ih-scaled differences and r = 2 dih / ih),
    chunked over the points: (out (B, M), dout (B, M), or (K, B, M) where
    the tangents carry a leading axis of K directions), the tangent's terms
    with k = 0 left out as the kernel leaves them out, a sample whose c is
    0 adding k dc alone (as the kernel stages it), the samples past
    ``n_live`` left out, the points past ``m_live`` zero."""
    B, D, N, M = _check(x, p, ih, il2, c, x.shape[-1])
    multi = _check_tangents(x, dih, dil2, dc)
    _check_counts(x, n_live, m_live)
    if not multi:
        dih, dil2, dc = (t.unsqueeze(0) for t in (dih, dil2, dc))
    K = dih.shape[0]
    xs, chunks = _point_chunks(x, p, ih, B * N * D * K)
    nl = _neg_half_widths(il2)
    ndl = (-0.5 * dil2).unsqueeze(-1)
    r = (2.0 * dih / ih)[..., None, None]
    c1, dc1 = c.unsqueeze(-1), dc.unsqueeze(-1)
    weightless = c1 == 0
    ok_i = _live_mask(n_live, B, N, x.device)
    out = torch.empty((B, M), dtype=x.dtype, device=x.device)
    dout = torch.empty((K, B, M), dtype=x.dtype, device=x.device)
    for sl, ps in chunks:
        u2 = torch.square(ps - xs)  # (B, D, N, m)
        z = u2.sum(1)
        k = torch.exp(nl * z)  # (B, N, m)
        term = dc1 + torch.where(  # (K, B, N, m)
            weightless, 0.0, c1 * (ndl * z + nl * (r * u2).sum(2)))
        keep = k != 0
        ck = c1 * k
        if ok_i is not None:
            keep = keep & ok_i.unsqueeze(-1)
            ck = torch.where(ok_i.unsqueeze(-1), ck, 0.0)
        out[:, sl] = ck.sum(1)
        dout[..., sl] = torch.where(keep, k * term, 0.0).sum(-2)
    ok_j = _live_mask(m_live, B, M, x.device)
    if ok_j is not None:
        out = torch.where(ok_j, out, 0.0)
        dout = torch.where(ok_j, dout, 0.0)
    return out, dout if multi else dout[0]


def _check_tangents(x, dih, dil2, dc):
    """The jvp's tangents: dih (B, D), dil2 and dc (B, N), or all three with
    one leading axis of K >= 1 directions; x's type and device. Returns
    whether they carry the direction axis."""
    B, D, N = x.shape
    multi = dih.dim() == 3
    lead = (dih.shape[0],) if multi else ()
    if multi and dih.shape[0] < 1:
        raise ValueError("the tangents carry no direction")
    for name, t, shape in (("dih", dih, lead + (B, D)),
                           ("dil2", dil2, lead + (B, N)),
                           ("dc", dc, lead + (B, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError("every input must share x's type and device")
    return multi


def _launch_args(x, p, ih, il2, last):
    x, ih, il2, last = (t.contiguous() for t in (x, ih, il2, last))
    p = p.contiguous()
    bstride = 0 if p.dim() == 2 else p.shape[1] * p.shape[2]
    return x, p, bstride, ih, il2, last


def _counts_ptr(counts):
    """(int32 contiguous counts or None, their device pointer or None)."""
    if counts is None:
        return None, None
    counts = counts.to(torch.int32).contiguous()
    return counts, counts.data_ptr()


def _ptr(t):
    return None if t is None else t.data_ptr()


def gauss_sum(x, p, ih, il2, c, n_live=None, m_live=None, splits=None,
              lib=None):
    """``out[b, j] = sum_i c[b,i] exp(-1/2 il2[b,i] sum_d ((p[d,j] -
    x[b,d,i]) ih[b,d])^2)``, (B, M), for x (B, D, N), p (D, M) shared or
    (B, D, M), ih (B, D), il2 and c (B, N); with live counts (B,) the
    samples past ``n_live[b]`` are left out and the points past
    ``m_live[b]`` are zero. CPU tensors take the plain version; CUDA
    tensors launch ``kde_gauss_sum`` on the current stream (nothing waits
    for the card) or raise. `splits` (default :func:`launch_splits`) and
    `lib` (another build's :func:`bind_library`) are for timing."""
    global sum_launch_count
    B, D, N, M = _check(x, p, ih, il2, c, x.shape[-1])
    _check_counts(x, n_live, m_live)
    if x.device.type == "cpu":
        return gauss_sum_reference(x, p, ih, il2, c, n_live, m_live)
    lib = kernel_library() if lib is None else lib
    x, p, bstride, ih, il2, c = _launch_args(x, p, ih, il2, c)
    n_live, n_ptr = _counts_ptr(n_live)
    m_live, m_ptr = _counts_ptr(m_live)
    out = torch.empty((B, M), dtype=x.dtype, device=x.device)
    suffix = "f64" if x.dtype == torch.float64 else "f32"
    with torch.cuda.device(x.device):
        if splits is None:
            splits = launch_splits("sum", D, x.dtype, B, M, N, lib)
        scratch = torch.empty((splits, B, M), dtype=x.dtype,
                              device=x.device) if splits > 1 else None
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"sum_{suffix}")(
            x.data_ptr(), p.data_ptr(), bstride, ih.data_ptr(),
            il2.data_ptr(), c.data_ptr(), n_ptr, m_ptr, out.data_ptr(),
            _ptr(scratch), B, D, N, M, int(splits), stream)
    if rc != 0:
        raise RuntimeError(f"kde_gauss_sum launch failed: CUDA error {rc}")
    sum_launch_count += 1
    return out


def gauss_sum_vjp(x, p, ih, il2, g, n_live=None, m_live=None, splits=None,
                  lib=None):
    """(A (B, N), C (B, D, N)) of :func:`gauss_sum` for the cotangent g
    (B, M): ``A[b,i] = sum_j g[b,j] k_ij``, ``C[b,d,i] = sum_j g[b,j] k_ij
    u_dij^2`` with u the ih-scaled difference and the terms with k = 0 left
    out (where u^2 overflows, 0 * inf would be NaN); with live counts the
    points past ``m_live[b]`` are left out and the samples past
    ``n_live[b]`` are zero. CPU tensors take the plain version; CUDA tensors
    launch ``kde_gauss_sum_vjp`` or raise. `splits` and `lib` as for
    :func:`gauss_sum`."""
    global vjp_launch_count
    B, D, N, M = _check(x, p, ih, il2, g, p.shape[-1])
    _check_counts(x, n_live, m_live)
    if x.device.type == "cpu":
        return gauss_sum_vjp_reference(x, p, ih, il2, g, n_live, m_live)
    lib = kernel_library() if lib is None else lib
    x, p, bstride, ih, il2, g = _launch_args(x, p, ih, il2, g)
    n_live, n_ptr = _counts_ptr(n_live)
    m_live, m_ptr = _counts_ptr(m_live)
    A = torch.empty((B, N), dtype=x.dtype, device=x.device)
    C = torch.empty((B, D, N), dtype=x.dtype, device=x.device)
    suffix = "f64" if x.dtype == torch.float64 else "f32"
    with torch.cuda.device(x.device):
        if splits is None:
            splits = launch_splits("vjp", D, x.dtype, B, N, M, lib)
        scratch = torch.empty((splits, B, 1 + D, N), dtype=x.dtype,
                              device=x.device) if splits > 1 else None
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"vjp_{suffix}")(
            x.data_ptr(), p.data_ptr(), bstride, ih.data_ptr(),
            il2.data_ptr(), g.data_ptr(), n_ptr, m_ptr, A.data_ptr(),
            C.data_ptr(), _ptr(scratch), B, D, N, M, int(splits), stream)
    if rc != 0:
        raise RuntimeError(f"kde_gauss_sum_vjp launch failed: CUDA error"
                           f" {rc}")
    vjp_launch_count += 1
    return A, C


def gauss_sum_jvp(x, p, ih, dih, il2, dil2, c, dc, n_live=None,
                  m_live=None, splits=None, lib=None):
    """(out, dout): :func:`gauss_sum` (B, M) and its tangents along the
    tangents dih (B, D), dil2 and dc (B, N) of ih, il2 and c (x and the
    points are data), ``dout[b,j] = sum_i k_ij (dc_i - 1/2 c_i (dil2_i z_ij
    + il2_i dz_ij))`` with ``dz_ij = sum_d 2 ih_d dih_d (p_dj - x_di)^2``
    and the terms with k = 0 left out; live counts as for
    :func:`gauss_sum`. With a leading axis of K directions on all three
    tangents ((K, B, D), (K, B, N), (K, B, N); 1 <= K <=
    :data:`MAX_DIRECTIONS`) dout is (K, B, M), from one launch that forms
    each pair's distance and exponential once. CPU tensors take the plain
    version; CUDA tensors launch ``kde_gauss_sum_jvp`` or raise. `splits`
    and `lib` as for :func:`gauss_sum`."""
    global jvp_launch_count
    B, D, N, M = _check(x, p, ih, il2, c, x.shape[-1])
    multi = _check_tangents(x, dih, dil2, dc)
    K = dih.shape[0] if multi else 1
    if K > MAX_DIRECTIONS:
        raise ValueError(f"one launch takes at most {MAX_DIRECTIONS}"
                         f" directions, not {K}")
    _check_counts(x, n_live, m_live)
    if x.device.type == "cpu":
        return gauss_sum_jvp_reference(x, p, ih, dih, il2, dil2, c, dc,
                                       n_live, m_live)
    lib = kernel_library() if lib is None else lib
    x, p, bstride, ih, il2, c = _launch_args(x, p, ih, il2, c)
    dih, dil2, dc = (t.contiguous() for t in (dih, dil2, dc))
    n_live, n_ptr = _counts_ptr(n_live)
    m_live, m_ptr = _counts_ptr(m_live)
    out = torch.empty((B, M), dtype=x.dtype, device=x.device)
    dout = torch.empty((K, B, M), dtype=x.dtype, device=x.device)
    suffix = "f64" if x.dtype == torch.float64 else "f32"
    with torch.cuda.device(x.device):
        if splits is None:
            splits = launch_splits("jvp", D, x.dtype, B, M, N, lib, K)
        scratch = torch.empty((splits, 1 + K, B, M), dtype=x.dtype,
                              device=x.device) if splits > 1 else None
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"jvp_{suffix}")(
            x.data_ptr(), p.data_ptr(), bstride, ih.data_ptr(),
            dih.data_ptr(), il2.data_ptr(), dil2.data_ptr(), c.data_ptr(),
            dc.data_ptr(), n_ptr, m_ptr, out.data_ptr(), dout.data_ptr(),
            _ptr(scratch), B, D, K, N, M, int(splits), stream)
    if rc != 0:
        raise RuntimeError(f"kde_gauss_sum_jvp launch failed: CUDA error"
                           f" {rc}")
    jvp_launch_count += 1
    return out, dout if multi else dout[0]


# -- the adaptive density ----------------------------------------------------------
def _widths(x, w, h, pilot, adaptive, alpha):
    """The per-sample quantities between the pilot and the sum at the
    points (torch ops, O(B N)): a dict of ih, K = (2 pi)^(D/2) prod h, the
    pilot's coefficients c0 and norm0 (guarded), log pilot, lambda, the
    norms (guarded), c and il2."""
    D = x.shape[1]
    ih = 1.0 / h
    K = (2.0 * math.pi) ** (D / 2.0) * h.prod(-1)
    # float32: a zero-weight channel's h is 1e-30 and K underflows to 0;
    # its terms are 0, so a guarded norm of 1 keeps the density 0 (not 0/0)
    norm0 = torch.where(K > 0, K, 1.0)
    out = {"ih": ih, "K": K, "norm0": norm0, "c0": w / norm0[:, None]}
    if adaptive:
        tiny = torch.finfo(x.dtype).tiny
        lp = torch.log(torch.clamp(pilot, min=tiny))
        log_g = (w * lp).sum(-1, keepdim=True)
        lam = torch.exp(-alpha * (lp - log_g))
        out["lp"] = lp
    else:
        lam = torch.ones_like(w)
    norm = K[:, None] * lam ** D
    norms = torch.where(norm > 0, norm, 1.0)
    out.update(lam=lam, norm=norm, norms=norms, c=w / norms,
               il2=1.0 / torch.square(lam))
    return out


class AdaptiveDensity(torch.autograd.Function):
    """(x (B, D, N), w (B, N) normalized, h (B, D), points (D, M) or
    (B, D, M), adaptive, alpha, counts) -> (density (B, M), pilot (B, N)):
    the density of ``pisa_tpu/utils/kde.py:adaptive_gaussian_kde`` after
    its bandwidths, differentiable in w and h (x and the points are data).
    The pilot (the fixed-width density at the samples; ones without
    `adaptive`) is returned for the backward and takes no gradient.
    `counts` (B,) integers or None: row b's samples past ``counts[b]`` are
    left out of every sum (the kernels' ``n_live``, and ``m_live`` of the
    pilot, whose points are the samples); their pilot is 0 (its log floored
    at the type's smallest normal number) and their weights must be 0, so
    that nothing of them reaches the density, and their gradients are
    finite.

    Forward: :func:`gauss_sum` at the samples (the pilot), then at the
    points. Backward: :func:`gauss_sum_vjp` at the points, the chain through
    the norms, lambda and the geometric mean in torch ops, and with
    `adaptive` a second :func:`gauss_sum_vjp` at the samples. Forward mode
    (jvp): :class:`_DensityTangent`, the backward's chain run forwards, on
    :func:`gauss_sum_jvp` at the samples (with `adaptive`) and at the
    points; its vmap rule hands the K directions of a ``torch.func.jacfwd``
    to the same two launches as their direction axis (in chunks of
    :data:`MAX_DIRECTIONS`). vmap: the vmapped axis joins the batch of one
    launch."""

    @staticmethod
    def forward(x, w, h, points, adaptive, alpha, counts):
        pilot = torch.ones_like(w)
        if adaptive:
            q = _widths(x, w, h, pilot, False, alpha)
            pilot = gauss_sum(x, x, q["ih"], pilot, q["c0"], counts, counts)
        q = _widths(x, w, h, pilot, adaptive, alpha)
        return gauss_sum(x, points, q["ih"], q["il2"], q["c"], counts), \
            pilot

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, h, points, adaptive, alpha, counts = inputs
        _, pilot = output
        ctx.mark_non_differentiable(pilot)
        ctx.save_for_backward(x, w, h, points, pilot, counts)
        ctx.save_for_forward(x, w, h, points, pilot, counts)
        ctx.adaptive = bool(adaptive)
        ctx.alpha = float(alpha)

    @staticmethod
    def backward(ctx, g_out, _g_pilot):
        x, w, h, points, pilot, counts = ctx.saved_tensors
        adaptive, alpha = ctx.adaptive, ctx.alpha
        D = x.shape[1]
        q = _widths(x, w, h, pilot, adaptive, alpha)
        lam, c, il2, norms = q["lam"], q["c"], q["il2"], q["norms"]
        A, C = gauss_sum_vjp(x, points, q["ih"], il2, g_out.contiguous(),
                             counts)
        # through the sum at the points: c, il2 and h directly
        g_h = (C * (c * il2)[:, None, :]).sum(-1) / h
        g_il2 = -0.5 * c * C.sum(1)
        # c = w / norms, norm = K lam^D (guarded where it underflowed, or
        # is 0 * inf: an empty channel's K and lambda in float32)
        g_w = A / norms
        pos = q["norm"] > 0
        g_norm = torch.where(pos, -A * c / norms, 0.0)
        g_K = torch.where(pos, g_norm * lam ** D, 0.0).sum(-1)
        g_lam = torch.where(pos, g_norm * q["K"][:, None] * D
                            * lam ** (D - 1), 0.0) - 2.0 * g_il2 / lam ** 3
        if adaptive:
            # lam = exp(-alpha (lp - log_g)), log_g = sum w lp
            t = alpha * lam * g_lam
            g_log_g = t.sum(-1, keepdim=True)
            g_w = g_w + g_log_g * q["lp"]
            g_lp = -t + g_log_g * w
            tiny = torch.finfo(x.dtype).tiny
            g_pilot = torch.where(pilot > tiny,
                                  g_lp / torch.where(pilot > tiny, pilot, 1.0),
                                  0.0)
            # the pilot: gauss_sum(x, x, ih, 1, c0), c0 = w / norm0
            A0, C0 = gauss_sum_vjp(x, x, q["ih"], torch.ones_like(w),
                                   g_pilot.contiguous(), counts, counts)
            g_h = g_h + (C0 * q["c0"][:, None, :]).sum(-1) / h
            g_w = g_w + A0 / q["norm0"][:, None]
            g_K = g_K + torch.where(
                q["K"] > 0, -(A0 * q["c0"]).sum(-1) / q["norm0"], 0.0)
        g_h = g_h + (g_K * q["K"])[:, None] / h
        return None, g_w, g_h, None, None, None, None

    @staticmethod
    def jvp(ctx, _dx, dw, dh, _dpoints, _dadaptive, _dalpha, _dcounts):
        # x and the points are data, as in backward: their tangents are
        # not followed
        x, w, h, points, pilot, counts = ctx.saved_tensors
        return _DensityTangent.apply(x, w, h, points, pilot, dw, dh,
                                     ctx.adaptive, ctx.alpha, counts), None

    @staticmethod
    def vmap(info, in_dims, x, w, h, points, adaptive, alpha, counts):
        size = info.batch_size
        xb, wb, hb, cb = _fold((x, w, h, counts),
                               in_dims[:3] + (in_dims[6],), size)
        B = xb.shape[0] // size
        pb = _fold_points(points, in_dims[3], size, B)
        out, pilot = AdaptiveDensity.apply(xb, wb, hb, pb, adaptive, alpha,
                                           cb)
        return (out.reshape(size, B, -1), pilot.reshape(size, B, -1)), (0, 0)


def _fold(tensors, dims, size):
    """Each tensor (or None) with its vmap axis `dim` first (expanded where
    it has none) and that axis merged into the batch axis after it."""
    out = []
    for t, d in zip(tensors, dims):
        if t is not None:
            t = t.movedim(d, 0) if d is not None else t.expand(
                (size,) + tuple(t.shape))
            t = t.reshape((-1,) + tuple(t.shape[2:]))
        out.append(t)
    return out


def _fold_points(points, dim, size, batch):
    """The points for a batch folded as :func:`_fold` does: (D, M) shared
    where no axis is vmapped, else (size * batch, D, M)."""
    if dim is None and points.dim() == 2:
        return points
    pb = points.movedim(dim, 0) if dim is not None else points.expand(
        (size,) + tuple(points.shape))
    if pb.dim() == 3:  # (size, D, M) -> (size, B, D, M)
        pb = pb.unsqueeze(1).expand(-1, batch, -1, -1)
    return pb.reshape((size * batch,) + tuple(pb.shape[2:]))


def _tangent_chunk(x, w, points, pilot, q, dw, dh, adaptive, alpha,
                   counts):
    """The density's tangents (K, B, M) along K <= MAX_DIRECTIONS
    directions dw (K, B, N) and dh (K, B, D) (either None: zero), given the
    widths `q` of the primal: ``_widths``'s chain run forwards in torch ops,
    broadcast over the directions, around one :func:`gauss_sum_jvp` launch
    at the samples (with `adaptive`) and one at the points."""
    D = x.shape[1]
    K = (dw if dw is not None else dh).shape[0]
    dw = w.new_zeros((K,) + tuple(w.shape)) if dw is None else dw
    dh = w.new_zeros((K,) + tuple(q["ih"].shape)) if dh is None else dh
    ih, Kn = q["ih"], q["K"]
    dih = -dh * ih * ih
    dK = Kn * (dh * ih).sum(-1)
    dnorm0 = torch.where(Kn > 0, dK, 0.0)
    dc0 = (dw - q["c0"] * dnorm0[..., None]) / q["norm0"][:, None]
    lam = q["lam"]
    if adaptive:
        _, dpilot = gauss_sum_jvp(x, x, ih, dih, torch.ones_like(w),
                                  torch.zeros_like(dw), q["c0"], dc0,
                                  counts, counts)
        tiny = torch.finfo(x.dtype).tiny
        live = pilot > tiny
        dlp = torch.where(live, dpilot / torch.where(live, pilot, 1.0), 0.0)
        dlog_g = (dw * q["lp"] + w * dlp).sum(-1, keepdim=True)
        dlam = -alpha * lam * (dlp - dlog_g)
    else:
        dlam = torch.zeros_like(dw)
    dnorm = torch.where(q["norm"] > 0, dK[..., None] * lam ** D
                        + Kn[:, None] * D * lam ** (D - 1) * dlam, 0.0)
    dc = (dw - q["c"] * dnorm) / q["norms"]
    dil2 = -2.0 * dlam / lam ** 3
    return gauss_sum_jvp(x, points, ih, dih, q["il2"], dil2, q["c"], dc,
                         counts)[1]


def _has_directions(t, dim, ref, ref_dim):
    """Whether tangent `t` (physical, vmapped at `dim` or not) carries a
    direction axis before the shape of its primal `ref` (vmapped at
    `ref_dim` or not)."""
    return t is not None and \
        t.dim() - (dim is not None) > ref.dim() - (ref_dim is not None)


class _DensityTangent(torch.autograd.Function):
    """The tangent (B, M) of :class:`AdaptiveDensity`'s density along the
    tangents dw (B, N) and dh (B, D) of w and h (None: zero), or the K
    tangents (K, B, M) where dw (K, B, N) and dh (K, B, D) carry a leading
    axis of K directions: the chain of ``_widths`` run forwards in torch
    ops around :func:`gauss_sum_jvp`, the pilot's launch at the samples (il2
    = 1, dil2 = 0; with `adaptive`) and the density's at the points, two
    launches for each :data:`MAX_DIRECTIONS` directions. The guards are the
    backward's: where a norm underflowed or the pilot is below the type's
    smallest normal number, the tangent through it is 0. `counts` as for
    :class:`AdaptiveDensity`. Its vmap rule: where only the tangents carry
    the vmapped axis (a ``torch.func.jacfwd``'s directions), that axis
    becomes the direction axis of the same launches; where the primals
    carry it as well (lanes), it is folded into the batch. A forward-mode
    rule: it has no backward."""

    @staticmethod
    def forward(x, w, h, points, pilot, dw, dh, adaptive, alpha, counts):
        multi = _has_directions(dw, None, w, None) or \
            _has_directions(dh, None, h, None)
        if not multi:
            dw, dh = (None if t is None else t.unsqueeze(0)
                      for t in (dw, dh))
        if dw is None and dh is None:
            dw = torch.zeros_like(w).unsqueeze(0)
        q = _widths(x, w, h, pilot, adaptive, alpha)
        K = (dw if dw is not None else dh).shape[0]
        parts = [_tangent_chunk(
            x, w, points, pilot, q,
            None if dw is None else dw[k0:k0 + MAX_DIRECTIONS],
            None if dh is None else dh[k0:k0 + MAX_DIRECTIONS],
            adaptive, alpha, counts) for k0 in range(0, K, MAX_DIRECTIONS)]
        out = parts[0] if len(parts) == 1 else torch.cat(parts)
        return out if multi else out[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, w, h, points, pilot, dw, dh, adaptive, alpha,
             counts):
        size = info.batch_size
        multi = _has_directions(dw, in_dims[5], w, in_dims[1]) or \
            _has_directions(dh, in_dims[6], h, in_dims[2])
        primals = (in_dims[0], in_dims[1], in_dims[2], in_dims[3],
                   in_dims[4], in_dims[9])
        if all(d is None for d in primals):
            # a jacfwd: the vmapped axis becomes (the front of) the
            # direction axis
            def lead(t, d):
                if t is None:
                    return None
                t = t.movedim(d, 0) if d is not None else t.expand(
                    (size,) + tuple(t.shape))
                return t.reshape((-1,) + tuple(t.shape[2:])) if multi else t
            out = _DensityTangent.apply(x, w, h, points, pilot,
                                        lead(dw, in_dims[5]),
                                        lead(dh, in_dims[6]), adaptive,
                                        alpha, counts)
            if multi:
                out = out.reshape((size, -1) + tuple(out.shape[1:]))
            return out, 0
        # lanes: the vmapped axis joins the batch, after any direction axis
        x, w, h, pilot, counts = _fold(
            (x, w, h, pilot, counts),
            (in_dims[0], in_dims[1], in_dims[2], in_dims[4], in_dims[9]),
            size)
        B = x.shape[0] // size
        pb = _fold_points(points, in_dims[3], size, B)
        if multi:
            def fold(t, d):
                if t is None:
                    return None
                t = t.movedim(d, 1) if d is not None else t.unsqueeze(
                    1).expand((t.shape[0], size) + tuple(t.shape[1:]))
                return t.reshape((t.shape[0], -1) + tuple(t.shape[3:]))
            dw, dh = fold(dw, in_dims[5]), fold(dh, in_dims[6])
        else:
            dw, dh = _fold((dw, dh), (in_dims[5], in_dims[6]), size)
        out = _DensityTangent.apply(x, w, h, pb, pilot, dw, dh, adaptive,
                                    alpha, counts)
        if multi:
            return out.reshape((out.shape[0], size, B, -1)), 1
        return out.reshape(size, B, -1), 0


def adaptive_density(x, w, h, points, adaptive=True, alpha=0.3,
                     counts=None):
    """The density (B, M) of :class:`AdaptiveDensity`."""
    return AdaptiveDensity.apply(x, w, h, points, adaptive, alpha,
                                 counts)[0]
