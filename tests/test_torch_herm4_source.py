"""
The math of ``pisa_tpu_torch/csrc/herm4_eig.cu`` compiled for the host with
the C++ compiler (its ``solve`` is ``__host__ __device__``): the cyclic
Jacobi eigen-decomposition of 4x4 complex Hermitian matrices against
numpy's ``eigh`` (eigenvalues to 1e-13 of the matrix's norm in float64,
1e-5 in float32; eigenvectors by their residual ``|H v - w v|``), at random
matrices, near-degenerate and exactly degenerate ones, non-Hermitian input,
the zero matrix and the 3+1 layer steps' Hamiltonians at the TeV resonance,
and the operation count behind the kernel's bound
(``herm4.herm4_operations``) against the source run with an
operation-counting scalar type. This checks the CUDA source's arithmetic
without a card; the kernel itself runs only on one (``chip_smoke.py``, the
``cuda`` tests here and in tests/test_torch_sterile.py). Skipped where no
C++ compiler is installed.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

from pisa_tpu_torch.ops.osc import herm4

_HARNESS = r"""
#include <cmath>
#include "herm4_eig.cu"
using namespace herm4;

static long long g_ops = 0;
struct Cnt {
  double v;
  Cnt() {}
  Cnt(double x) : v(x) {}
};
inline Cnt operator+(Cnt a, Cnt b) { ++g_ops; return Cnt(a.v + b.v); }
inline Cnt operator-(Cnt a, Cnt b) { ++g_ops; return Cnt(a.v - b.v); }
inline Cnt operator*(Cnt a, Cnt b) { ++g_ops; return Cnt(a.v * b.v); }
inline Cnt operator/(Cnt a, Cnt b) { ++g_ops; return Cnt(a.v / b.v); }
inline Cnt operator-(Cnt a) { return Cnt(-a.v); }
inline double value(Cnt x) { return x.v; }
inline Cnt h4_sqrt(Cnt x) { ++g_ops; return Cnt(std::sqrt(x.v)); }
inline Cnt h4_rsqrt(Cnt x) { ++g_ops; return Cnt(1.0 / std::sqrt(x.v)); }
inline Cnt h4_fabs(Cnt x) { return Cnt(std::fabs(x.v)); }

static const double kTol64 = 2.220446049250313e-16 * 2.220446049250313e-16;
static const float kEps32 = 1.1920928955078125e-07f;

extern "C" {
int solve_f64(const double* m, double* w, double* v, long long n) {
  int most = 0;
  for (long long i = 0; i < n; ++i) {
    int s = solve(m + 32 * i, kTol64, w + 4 * i, v + 32 * i);
    most = s > most ? s : most;
  }
  return most;
}
void solve_f32(const float* m, float* w, float* v, int* sweeps, long long n) {
  for (long long i = 0; i < n; ++i)
    sweeps[i] = solve(m + 32 * i, kEps32 * kEps32, w + 4 * i, v + 32 * i);
}
long long count_ops(const double* m, int* sweeps) {
  Cnt mc[32], w[4], v[32];
  for (int k = 0; k < 32; ++k) mc[k] = Cnt(m[k]);
  g_ops = 0;
  *sweeps = solve(mc, Cnt(kTol64), w, v);
  return g_ops;
}
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a C++ compiler to build the kernel source for the"
                    " host")
    d = tmp_path_factory.mktemp("herm4_host")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    lib_path = d / "libharness.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
         os.path.dirname(herm4._CSRC), "-o", str(lib_path), str(src)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    p = ctypes.c_void_p
    lib.solve_f64.argtypes = [p, p, p, ctypes.c_longlong]
    lib.solve_f32.argtypes = [p, p, p, p, ctypes.c_longlong]
    lib.count_ops.argtypes = [p, p]
    lib.count_ops.restype = ctypes.c_longlong
    return lib


def _ptr(a):
    return a.ctypes.data


def _random_hermitian(n, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    a = rng.normal(size=(n, 4, 4)) + 1j * rng.normal(size=(n, 4, 4))
    return scale * 0.5 * (a + np.conj(np.swapaxes(a, -1, -2)))


def _near_degenerate(n, seed):
    """V diag(w) V^H with two eigenvalues 1e-9 apart (the high-energy mu/tau
    pair) and a well-separated pair."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, 4, 4))
                        + 1j * rng.normal(size=(n, 4, 4)))
    w = np.array([-3.0, 0.7, 0.7 + 1e-9, 5.0])
    return np.einsum("nij,j,nkj->nik", q, w, np.conj(q))


def _resonance_hamiltonians():
    """The 3+1 layer steps' flavour-basis Hamiltonians (1/2E-scaled, as
    ``sterile._layer_phase_and_projectors`` builds them) over the resonance
    set of tests/test_sterile.py:304 (PREM-12 chains at coszen -1..-0.3,
    100 GeV to 2 TeV, both signs)."""
    from pisa_tpu_torch.ops.osc import sterile
    from pisa_tpu_torch.ops.osc.kernels import TWO_SQRT2_GF

    U = sterile.pmns4_matrix(0.5839, 0.1496, 0.7854, 0.12, 0.15, 0.0, 1.2,
                             0.0, 0.0).numpy()
    d = np.diag([0.0, 7.42e-5, 2.514e-3, 1.0])
    h_vac = U @ d @ np.conj(U.T)
    out = []
    for energy in (100.0, 500.0, 2000.0):
        for sign in (1, -1):
            for rho in (3.3, 5.5, 10.0, 13.0):
                hv = h_vac if sign > 0 else np.conj(h_vac)
                diag = sign * 0.5 * TWO_SQRT2_GF * np.diag(
                    [0.49 * rho, 0.0, 0.0, 0.5 * 0.51 * rho])
                out.append(hv / (2 * energy) + diag)
    return np.asarray(out)


def _interleaved(h, dtype):
    return np.ascontiguousarray(h.astype(np.complex128)).view(
        np.float64).astype(dtype)


def _check(h, w, v, rtol):
    """Ascending eigenvalues against numpy's, and residuals of the
    eigenvectors, both relative to the matrix's norm."""
    want = np.linalg.eigvalsh(h)
    norm = np.linalg.norm(h, axis=(-2, -1))[:, None]
    assert np.all(np.diff(w, axis=-1) >= 0)
    np.testing.assert_array_less(np.abs(w - want) / norm, rtol)
    resid = np.einsum("nij,njk->nik", h, v) - v * w[:, None, :]
    np.testing.assert_array_less(
        np.linalg.norm(resid, axis=-2) / norm, 10 * rtol)
    gram = np.einsum("nji,njk->nik", np.conj(v), v)
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(4), gram.shape),
                               atol=10 * rtol)


@pytest.mark.parametrize("kind", ["random", "tiny", "near_degenerate",
                                  "resonance"])
def test_jacobi_matches_numpy_f64(host_lib, kind):
    h = {"random": lambda: _random_hermitian(200, 1),
         "tiny": lambda: _random_hermitian(50, 2, scale=1e-7),
         "near_degenerate": lambda: _near_degenerate(50, 3),
         "resonance": _resonance_hamiltonians}[kind]()
    n = h.shape[0]
    m = _interleaved(h, np.float64)
    w = np.zeros((n, 4))
    v = np.zeros((n, 32))
    most = host_lib.solve_f64(_ptr(m), _ptr(w), _ptr(v), n)
    assert 1 <= most <= 8
    vc = v.view(np.complex128).reshape(n, 4, 4)
    _check(h, w, vc, 1e-13)


def test_jacobi_f32_and_non_hermitian_input(host_lib):
    """float32 at the float32 bound; an input with round-off asymmetry is
    taken by its Hermitian part, as the plain version takes it."""
    h = _resonance_hamiltonians()
    n = h.shape[0]
    rng = np.random.RandomState(4)
    skew = 1e-9 * np.abs(h).max() * rng.normal(size=h.shape)
    m = _interleaved(h + skew, np.float32)
    w = np.zeros((n, 4), dtype=np.float32)
    v = np.zeros((n, 32), dtype=np.float32)
    sweeps = np.zeros(n, dtype=np.int32)
    host_lib.solve_f32(_ptr(m), _ptr(w), _ptr(v), _ptr(sweeps), n)
    herm = 0.5 * ((h + skew) + np.conj(np.swapaxes(h + skew, -1, -2)))
    vc = v.astype(np.float64).view(np.complex128).reshape(n, 4, 4)
    _check(herm, w.astype(np.float64), vc, 1e-5)
    assert sweeps.max() < herm4.MAX_SWEEPS


def test_zero_matrix(host_lib):
    m = np.zeros(32)
    w = np.full(4, np.nan)
    v = np.zeros(32)
    assert host_lib.solve_f64(_ptr(m), _ptr(w), _ptr(v), 1) == 0
    np.testing.assert_array_equal(w, 0.0)
    np.testing.assert_array_equal(
        v.view(np.complex128).reshape(4, 4), np.eye(4))


def test_operation_count_matches_formula(host_lib):
    """herm4_operations(sweeps) is the source's count, rotation by
    rotation, at matrices that take different numbers of sweeps."""
    h = np.concatenate([_random_hermitian(5, 6), _near_degenerate(3, 7),
                        _resonance_hamiltonians()[:6]])
    seen = set()
    for x in h:
        m = _interleaved(x[None], np.float64)[0]
        sweeps = ctypes.c_int()
        ops = host_lib.count_ops(_ptr(m), ctypes.addressof(sweeps))
        seen.add(sweeps.value)
        assert ops == herm4.herm4_operations([sweeps.value])
    assert len(seen) >= 2


# -- float32, degenerate and non-Hermitian input ------------------------------
def _solve(host_lib, h, dtype):
    n = h.shape[0]
    m = _interleaved(h, dtype)
    w = np.zeros((n, 4), dtype=dtype)
    v = np.zeros((n, 32), dtype=dtype)
    sweeps = np.zeros(n, dtype=np.int32)
    if dtype == np.float64:
        host_lib.solve_f64(_ptr(m), _ptr(w), _ptr(v), n)
    else:
        host_lib.solve_f32(_ptr(m), _ptr(w), _ptr(v), _ptr(sweeps), n)
    vc = v.astype(np.float64).view(np.complex128).reshape(n, 4, 4)
    return w.astype(np.float64), vc, sweeps


def _non_hermitian(n, seed):
    rng = np.random.RandomState(seed)
    return rng.normal(size=(n, 4, 4)) + 1j * rng.normal(size=(n, 4, 4))


@pytest.mark.parametrize("kind", ["random", "tiny", "near_degenerate",
                                  "resonance", "non_hermitian"])
def test_jacobi_matches_numpy_f32(host_lib, kind):
    """float32 at the float32 bound; a non-Hermitian input is taken by its
    Hermitian part."""
    h = {"random": lambda: _random_hermitian(200, 1),
         "tiny": lambda: _random_hermitian(50, 2, scale=1e-7),
         "near_degenerate": lambda: _near_degenerate(50, 3),
         "resonance": _resonance_hamiltonians,
         "non_hermitian": lambda: _non_hermitian(40, 8)}[kind]()
    w, v, sweeps = _solve(host_lib, h, np.float32)
    herm = 0.5 * (h + np.conj(np.swapaxes(h, -1, -2)))
    _check(herm, w, v, 1e-5)
    assert 1 <= sweeps.max() < herm4.MAX_SWEEPS


def test_jacobi_non_hermitian_f64(host_lib):
    h = _non_hermitian(40, 8)
    w, v, _ = _solve(host_lib, h, np.float64)
    herm = 0.5 * (h + np.conj(np.swapaxes(h, -1, -2)))
    _check(herm, w, v, 1e-13)


def test_jacobi_exactly_degenerate_and_zero(host_lib):
    """Exactly degenerate eigenvalues (a multiple of the identity, which
    takes no sweep, and a doubly degenerate pair) in both types, and the
    zero matrix in float32 (no sweep, identity eigenvectors)."""
    rng = np.random.RandomState(4)
    q, _ = np.linalg.qr(rng.normal(size=(4, 4)) + 1j * rng.normal(
        size=(4, 4)))
    degenerate = np.stack([3.0 * np.eye(4), q @ np.diag([1.0, 1.0, 2.0, 5.0])
                           @ np.conj(q.T)])
    for dtype, rtol in ((np.float64, 1e-13), (np.float32, 1e-5)):
        w, v, _ = _solve(host_lib, degenerate, dtype)
        _check(degenerate, w, v, rtol)
    w, v, sweeps = _solve(host_lib, np.zeros((1, 4, 4)), np.float32)
    assert sweeps[0] == 0
    np.testing.assert_array_equal(w, 0.0)
    np.testing.assert_array_equal(v[0], np.eye(4))


def test_operation_count_at_non_hermitian_and_degenerate(host_lib):
    """herm4_operations(sweeps) also counts non-Hermitian input (the
    Hermitian part costs the same) and a doubly degenerate pair."""
    rng = np.random.RandomState(5)
    q, _ = np.linalg.qr(rng.normal(size=(4, 4)) + 1j * rng.normal(
        size=(4, 4)))
    h = np.concatenate([_non_hermitian(6, 9), (q @ np.diag(
        [1.0, 1.0, 2.0, 5.0]) @ np.conj(q.T))[None]])
    seen = set()
    for x in h:
        m = _interleaved(x[None], np.float64)[0]
        sweeps = ctypes.c_int()
        ops = host_lib.count_ops(_ptr(m), ctypes.addressof(sweeps))
        seen.add(sweeps.value)
        assert ops == herm4.herm4_operations([sweeps.value])
    assert len(seen) >= 2


# -- the kernel on a card ---------------------------------------------------------
@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [("complex128", 1e-13),
                                        ("complex64", 1e-5)])
def test_kernel_matches_numpy_on_the_card(cuda_device, dtype, rtol):
    """The default build at the host tests' matrices (a batch that leaves
    a partial block, the zero matrix and a non-Hermitian input among them)
    against numpy, with the sweeps it reports."""
    import torch

    rng = np.random.RandomState(9)
    a = rng.normal(size=(7, 4, 4)) + 1j * rng.normal(size=(7, 4, 4))
    h = np.concatenate([_random_hermitian(101, 1), _near_degenerate(30, 3),
                        _resonance_hamiltonians(), np.zeros((1, 4, 4)), a])
    H = torch.as_tensor(h).to(getattr(torch, dtype)).to(cuda_device)
    before = herm4.launch_count
    w, v, sweeps = herm4.herm4_eig(H, sweeps=True)
    torch.cuda.synchronize()
    assert herm4.launch_count == before + 1
    herm = 0.5 * (h + np.conj(np.swapaxes(h, -1, -2)))
    keep = np.linalg.norm(herm, axis=(-2, -1)) > 0
    _check(herm[keep], w.double().cpu().numpy()[keep],
           v.to(torch.complex128).cpu().numpy()[keep], rtol)
    assert int(sweeps.cpu()[~torch.as_tensor(keep)].max()) == 0
    assert int(sweeps.max()) < herm4.MAX_SWEEPS
