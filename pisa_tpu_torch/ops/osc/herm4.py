"""
Eigenvalues of batched 4x4 complex Hermitian matrices, for the 3+1 layer
step (``ops/osc/sterile.py``).

The JAX package takes them with ``jnp.linalg.eigvalsh`` on an 8x8 real
embedding (``pisa_tpu/ops/osc/sterile.py:_eigvals_hermitian4``), a TPU
workaround for the missing complex types. The plain torch call,
``torch.linalg.eigvalsh``, synchronizes its CUDA device with the host (it
checks for a convergence failure there) and has no variant without the
check, so a CUDA graph cannot capture it, and every fit route of the port
replays a captured program (its cuSOLVER route also refuses batches of
32,768 4x4 matrices and more on the H100 machine, torch 2.11 with CUDA
12.8). The card therefore runs a hand-written kernel,
``pisa_tpu_torch/csrc/herm4_eig.cu`` (cyclic Jacobi, one thread a matrix,
the block's matrices staged through shared memory as 16-byte words), which
reads nothing back:

- :func:`herm4_eig`: the eigenvalues in ascending order and the
  eigenvectors (as columns); CPU tensors go through the plain version,
  :func:`herm4_eig_reference` (``torch.linalg.eigh`` of the Hermitian
  part), CUDA tensors launch the kernel or raise;
- :func:`eigvalsh4` / :class:`Herm4Eig`: the eigenvalues, differentiable in
  both modes and under ``torch.func.vmap``: backward ``gH = sum_k g_k v_k
  v_k^H``, jvp ``dm_k = Re(v_k^H dH v_k)`` (only eigenvalue derivatives,
  which stay finite where two eigenvalues nearly coincide), and a vmap rule
  that folds the vmapped axis into the batch (the matrices are
  independent).

Both versions take the Hermitian part ``(H + H^H) / 2`` of their input, as
the JAX package symmetrizes its embedding.
"""

from __future__ import annotations

import ctypes
import os
import types

import torch

from pisa_tpu_torch.ops.osc.kernels import _dagger, _mm

__all__ = [
    "herm4_eig",
    "herm4_eig_reference",
    "eigvalsh4",
    "Herm4Eig",
    "hermitian_part",
    "herm4_operations",
    "kernel_library",
    "kernel_attributes",
    "launch_count",
    "MAX_SWEEPS",
]

#: the kernel's bound on its sweeps (``csrc/herm4_eig.cu`` kMaxSweeps)
MAX_SWEEPS = 16

#: Number of launches of the CUDA kernel made in this process by
#: :func:`herm4_eig` (incremented where the kernel is launched, and
#: nowhere else).
launch_count = 0

_CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "csrc",
    "herm4_eig.cu",
)
_LIB = None
_P, _LL = ctypes.c_void_p, ctypes.c_longlong


def herm4_operations(sweeps):
    """Floating-point operations of the kernel over its matrices, from the
    sweeps each took (an int tensor or array, one entry per matrix): each
    add, subtract, multiply, divide, sqrt and rsqrt counts one; compares,
    selects and negations count nothing. A matrix costs 61 (the Hermitian
    part, the scaling and the scaling back), 31 per convergence check (one
    more than its sweeps, unless it stopped at the bound) and 846 per sweep
    (6 rotations of 141); ``tests/test_torch_herm4_source.py`` checks these
    numbers against the source compiled for the host with an
    operation-counting type."""
    sweeps = torch.as_tensor(sweeps).to(torch.int64)
    checks = sweeps + (sweeps < MAX_SWEEPS).to(torch.int64)
    return int((61 + 31 * checks + 846 * sweeps).sum())


def hermitian_part(H):
    """(H + H^H) / 2."""
    return 0.5 * (H + _dagger(H))


def _check(H):
    if H.dtype not in (torch.complex64, torch.complex128) or H.dim() < 2 \
            or tuple(H.shape[-2:]) != (4, 4):
        raise ValueError("herm4_eig takes complex64/complex128 (..., 4, 4)"
                         f" matrices; got {H.dtype} {tuple(H.shape)}")


def herm4_eig_reference(H):
    """The plain version: ``torch.linalg.eigh`` of the Hermitian part of
    `H` (..., 4, 4): the eigenvalues (..., 4) in ascending order and the
    eigenvectors (..., 4, 4), as columns."""
    _check(H)
    return torch.linalg.eigh(hermitian_part(H))


def kernel_library():
    """The kernel's entry points (ctypes functions ``herm4_eig_f32``,
    ``herm4_eig_f64``, ``herm4_eig_attributes_f32``, ...), built from
    ``csrc/herm4_eig.cu`` at first use (``utils/cuda_build.py``)."""
    global _LIB
    if _LIB is None:
        from pisa_tpu_torch.utils.cuda_build import build_libraries

        lib = build_libraries({"herm4_eig": ([_CSRC], [])})["herm4_eig"]
        fns = {}
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"herm4_eig_{suffix}")
            fn.argtypes = [_P, _P, _P, _P, _LL, _P]
            fn.restype = ctypes.c_int
            fns[f"herm4_eig_{suffix}"] = fn
            attrs = getattr(lib, f"herm4_eig_attributes_{suffix}")
            attrs.argtypes = [_P]
            attrs.restype = ctypes.c_int
            fns[f"attributes_{suffix}"] = attrs
        _LIB = types.SimpleNamespace(**fns)
    return _LIB


def kernel_attributes(dtype):
    """The kernel's resources in `dtype` (float32/float64 or their complex
    types) on the current card: registers per thread, local-memory bytes
    per thread, shared bytes per block, threads per block and resident
    blocks per SM."""
    f64 = dtype in (torch.float64, torch.complex128)
    fn = getattr(kernel_library(), "attributes_f64" if f64 else "attributes_f32")
    info = (ctypes.c_int * 5)()
    rc = fn(ctypes.addressof(info))
    if rc != 0:
        raise RuntimeError(f"herm4_eig attributes: CUDA error {rc}")
    keys = ("registers", "local_bytes", "shared_bytes", "threads",
            "blocks_per_sm")
    return dict(zip(keys, info))


def herm4_eig(H, sweeps=False):
    """Eigenvalues (..., 4), ascending, and eigenvectors (..., 4, 4), as
    columns, of the Hermitian part of the complex (..., 4, 4) matrices `H`.

    CPU tensors go through :func:`herm4_eig_reference`; CUDA tensors launch
    the kernel on the current stream (nothing waits for the card) or raise.
    With `sweeps` (CUDA only), also the (...,) int32 sweeps each matrix
    took, from which :func:`herm4_operations` counts the kernel's work."""
    global launch_count
    _check(H)
    if H.device.type == "cpu":
        if sweeps:
            raise ValueError("sweeps are counted by the CUDA kernel only")
        return herm4_eig_reference(H)
    if H.device.type != "cuda":
        raise ValueError(f"unsupported device {H.device}")
    lead = tuple(H.shape[:-2])
    flat = H.reshape(-1, 4, 4).contiguous()
    if flat.data_ptr() % 16:  # the kernel loads 16-byte words
        flat = flat.clone()
    n = flat.shape[0]
    real = torch.float64 if H.dtype == torch.complex128 else torch.float32
    w = torch.empty((n, 4), dtype=real, device=H.device)
    v = torch.empty((n, 4, 4), dtype=H.dtype, device=H.device)
    sw = torch.empty((n,), dtype=torch.int32, device=H.device) if sweeps \
        else None
    fn = getattr(kernel_library(),
                 "herm4_eig_f64" if real == torch.float64 else "herm4_eig_f32")
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        rc = fn(flat.data_ptr(), w.data_ptr(), v.data_ptr(),
                None if sw is None else sw.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"herm4_eig kernel launch failed: CUDA error {rc}")
    launch_count += 1
    out = (w.reshape(lead + (4,)), v.reshape(lead + (4, 4)))
    return out + (sw.reshape(lead),) if sweeps else out


class Herm4Eig(torch.autograd.Function):
    """H (..., 4, 4) complex Hermitian -> (eigenvalues (..., 4) ascending,
    eigenvectors (..., 4, 4)) by :func:`herm4_eig`; only the eigenvalues
    are differentiable. backward: ``gH = sum_k g_k v_k v_k^H``. jvp:
    ``dm_k = Re(v_k^H dH v_k)``, in torch ops, so that ``torch.func.jacfwd``
    batches it as any op. vmap: the vmapped axis joins the batch of one
    launch. Nothing is read on the host."""

    @staticmethod
    def forward(H):
        return herm4_eig(H)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, V = output
        ctx.mark_non_differentiable(V)
        ctx.save_for_backward(V)
        ctx.save_for_forward(V)

    @staticmethod
    def backward(ctx, gw, _gV):
        (V,) = ctx.saved_tensors
        return _mm(V * gw.unsqueeze(-2).to(V.dtype), _dagger(V))

    @staticmethod
    def jvp(ctx, dH):
        (V,) = ctx.saved_tensors
        X = _mm(dH, V)  # column k: dH v_k
        dw = (V.real * X.real + V.imag * X.imag).sum(-2)
        return dw, None

    @staticmethod
    def vmap(info, in_dims, H):
        if in_dims[0] is None:
            return Herm4Eig.apply(H), (None, None)
        return Herm4Eig.apply(H.movedim(in_dims[0], 0)), (0, 0)


def eigvalsh4(H):
    """The eigenvalues (..., 4), in ascending order, of the Hermitian part of
    the complex (..., 4, 4) matrices `H`, differentiable (:class:`Herm4Eig`):
    the kernel on a card, the plain version on the CPU."""
    return Herm4Eig.apply(H)[0]
