"""
The math of ``pisa_tpu_torch/csrc/osc_chain.cu`` compiled for the host with
the C++ compiler (its per-point ``chain_point`` and the three phases of the
layer-parallel tile pass are ``__host__ __device__``): the primal and the
dual-number tangents against the port's plain versions, the tile pass,
driven by a host loop over lanes, tiles and the threads of each phase,
against both (with several lanes: each lane against a single-lane pass at
its pack, through the kernels' own lane offsets), and the operation counts
behind the kernels' bounds (``chain.chain_operations``). This checks the
CUDA source's arithmetic without a card; the kernels themselves run only on
one (``chip_smoke.py``, the ``cuda`` tests). Skipped where no C++ compiler
is installed.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pisa_tpu_torch.ops.osc import chain
from pisa_tpu_torch.ops.osc.layers import Layers

THETA = [0.5903, 0.1503, 0.8587, 3.4, 7.39e-5, 2.528e-3]
ACTIVE = [1, 2, 5]  # theta13, theta23, dm31: the flagship's free ones

# Loops over points for the plain and dual instances, and the same chain
# run with an operation-counting scalar type.
_HARNESS = r"""
#include <vector>

#include "osc_chain.cu"
using namespace osc_chain;

template <typename S>
void primal(const S* p, const int* nl, const S* e, const S* dens,
            const S* dist, S* out, int n) {
  for (int i = 0; i < n; ++i) {
    S r[6];
    chain_point(PlainPack<S>{p}, nl[i], e[i], dens + i, dist + i,
                (size_t)n, r);
    for (int k = 0; k < 6; ++k) out[(size_t)k * n + i] = r[k];
  }
}

template <typename S, int K>
void dual(const S* p, const S* dp, const int* nl, const S* e, const S* dens,
          const S* dist, S* out, S* dout, int n) {
  for (int i = 0; i < n; ++i) {
    Dual<S, K> r[6];
    chain_point(DualPack<S, K>{p, dp}, nl[i], e[i], dens + i, dist + i,
                (size_t)n, r);
    for (int k = 0; k < 6; ++k) {
      out[(size_t)k * n + i] = r[k].v;
      for (int j = 0; j < K; ++j) dout[(size_t)(6 * j + k) * n + i] = r[k].d[j];
    }
  }
}

// A tile kernel's blocks, one lane and one tile after another: each lane's
// pack, directions and outputs through the kernels' lane_slices, then each
// phase's work items in turn (phase 1 by chunks of C1 of the K directions,
// phase 2 by chunks of C2), with the shared memory poisoned (NaN) before
// each tile so that a read of another tile's data shows. The table is cut
// to `steps` steps a tile.
constexpr int chunks(int k, int c) { return c == 0 ? 1 : (k + c - 1) / c; }

template <typename S, int K, int C1, int C2>
void tile_pass(const S* pvec, const S* dpvec, const int* tiles, int n_tiles,
               const int* point_step, const int* step_point, const S* rho,
               const S* dx, const S* e, S* out, S* dout, int n, int steps,
               int lanes) {
  constexpr int n1 = chunks(K, C1), n2 = chunks(K, C2);
  constexpr int k_pack = n1 * C1 > n2 * C2 ? n1 * C1 : n2 * C2;
  std::vector<S> t((size_t)steps * 18 * (1 + K)), pack(kPack * (1 + k_pack)),
      energy(kTilePoints);
  std::vector<unsigned char> picks(kTilePoints);
  const TileMem<S> m{pack.data(), energy.data(), picks.data(), t.data(),
                     steps};
  for (int lane = 0; lane < lanes; ++lane) {
    const LaneSlices<S> sl = lane_slices(pvec, dpvec, out, dout, K, n, lane);
    for (int k = 0; k < kPack * (1 + k_pack); ++k)
      pack[k] = k < kPack ? sl.pack[k]
                          : (k < kPack * (1 + K) ? sl.dirs[k - kPack] : S(0));
    for (int b = 0; b < n_tiles; ++b) {
      for (auto& x : t) x = std::nan("");
      for (auto& x : energy) x = std::nan("");
      const Tile tile = tile_at(tiles, b);
      for (int j = 0; j < tile.n_points; ++j) tile_phase0(tile, j, e, m);
      for (int w = 0; w < tile.n_steps * n1; ++w)
        tile_phase1<S, K, C1>(tile, w % tile.n_steps, w / tile.n_steps * C1,
                              step_point, rho, dx, m);
      const int walks = 2 * tile.n_points;
      for (int w = 0; w < walks * n2; ++w)
        tile_phase2<S, K, C2>(tile, w % walks, w / walks * C2, point_step, m,
                              sl.out, sl.dout, n);
    }
  }
}

// The multitangent pass over double with K directions in chunks of (C1, C2),
// or in the chunks the kernel ships with where c1 is 0.
template <int K>
int multi_pass(int c1, int c2, const double* p, const double* dp,
               const int* tiles, int n_tiles, const int* point_step,
               const int* step_point, const double* rho, const double* dx,
               const double* e, double* out, double* dout, int n, int steps,
               int lanes) {
  using Shape = MultiShape<double, K>;
#define OSC_PASS(C1, C2)                                                     \
  if (c1 == (C1) && c2 == (C2)) {                                            \
    tile_pass<double, K, ((C1) < K ? (C1) : K), ((C2) < K ? (C2) : K)>(      \
        p, dp, tiles, n_tiles, point_step, step_point, rho, dx, e, out,      \
        dout, n, steps, lanes);                                              \
    return 0;                                                                \
  }
  if (c1 == 0) {
    tile_pass<double, K, Shape::c1, Shape::c2>(p, dp, tiles, n_tiles,
                                               point_step, step_point, rho,
                                               dx, e, out, dout, n, steps,
                                               lanes);
    return 0;
  }
  OSC_PASS(1, 1) OSC_PASS(1, 6) OSC_PASS(2, 1) OSC_PASS(2, 2) OSC_PASS(3, 1)
  OSC_PASS(3, 3) OSC_PASS(4, 4) OSC_PASS(6, 1) OSC_PASS(6, 6)
#undef OSC_PASS
  return 1;
}

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
inline bool operator<(Cnt a, Cnt b) { return a.v < b.v; }
inline bool operator>(Cnt a, Cnt b) { return a.v > b.v; }
inline Cnt value(Cnt x) { return x; }
inline Cnt osc_sqrt(Cnt x) { ++g_ops; return Cnt(std::sqrt(x.v)); }
inline Cnt osc_rsqrt(Cnt x) { ++g_ops; return Cnt(1.0 / std::sqrt(x.v)); }
inline Cnt osc_atan2(Cnt y, Cnt x) { ++g_ops; return Cnt(std::atan2(y.v, x.v)); }
inline Cnt osc_fabs(Cnt x) { return Cnt(std::fabs(x.v)); }
inline void osc_sincos(Cnt x, Cnt* s, Cnt* c) {
  ++g_ops;
  s->v = std::sin(x.v);
  c->v = std::cos(x.v);
}

template <int K>
long long count(const double* p, int nl, double e, const double* dens,
                const double* dist) {
  Cnt pc[kPack * (1 + kMaxTangents)];
  for (int k = 0; k < kPack * (1 + K); ++k) pc[k] = Cnt(k < kPack ? p[k] : 0.5);
  Cnt dn[64], dx[64];
  for (int l = 0; l < nl; ++l) {
    dn[l] = Cnt(dens[l]);
    dx[l] = Cnt(dist[l]);
  }
  g_ops = 0;
  if (K == 0) {
    Cnt r[6];
    chain_point(PlainPack<Cnt>{pc}, nl, Cnt(e), dn, dx, 1, r);
  } else {
    constexpr int KD = K == 0 ? 1 : K;
    Dual<Cnt, KD> r[6];
    chain_point(DualPack<Cnt, KD>{pc, pc + kPack}, nl, Cnt(e), dn, dx, 1, r);
  }
  return g_ops;
}

extern "C" {
void tile_shape(int* out) {
  out[0] = kTileSteps;
  out[1] = kTilePoints;
  out[2] = kTileThreads;
  out[3] = kMaxLanes;
}
void tiles_primal_f64(const double* p, const int* tiles, int n_tiles,
                      const int* point_step, const int* step_point,
                      const double* rho, const double* dx, const double* e,
                      double* out, int n, int lanes) {
  tile_pass<double, 0, 0, 0>(p, nullptr, tiles, n_tiles, point_step,
                             step_point, rho, dx, e, out, nullptr, n,
                             kTileSteps, lanes);
}
void tiles_tangent_f64(const double* p, const double* dp, const int* tiles,
                       int n_tiles, const int* point_step,
                       const int* step_point, const double* rho,
                       const double* dx, const double* e, double* dout,
                       int n, int lanes) {
  tile_pass<double, 1, 1, 1>(p, dp, tiles, n_tiles, point_step, step_point,
                             rho, dx, e, nullptr, dout, n, kTileSteps, lanes);
}
// returns 1 for a (k, c1, c2) that is not instantiated
int tiles_multi_f64(int k, int c1, int c2, const double* p, const double* dp,
                    const int* tiles, int n_tiles, const int* point_step,
                    const int* step_point, const double* rho,
                    const double* dx, const double* e, double* out,
                    double* dout, int n, int steps, int lanes) {
  switch (k) {
#define OSC_K(K)                                                            \
  case K:                                                                   \
    return multi_pass<K>(c1, c2, p, dp, tiles, n_tiles, point_step,         \
                         step_point, rho, dx, e, out, dout, n, steps,       \
                         lanes);
    OSC_K(1) OSC_K(2) OSC_K(3) OSC_K(4) OSC_K(5) OSC_K(6)
#undef OSC_K
  }
  return 1;
}
// (c1, c2, threads) the multitangent kernel ships with, and its shared bytes
// at tiles of `steps` steps
void multi_shape(int f64, int k, int steps, long long* out) {
  switch (2 * k + (f64 ? 1 : 0)) {
#define OSC_SHAPE(K)                                                        \
  case 2 * K: {                                                             \
    using Sh = MultiShape<float, K>;                                        \
    out[0] = Sh::c1; out[1] = Sh::c2; out[2] = Sh::threads;                 \
    out[3] = (long long)Sh::shared_bytes(steps);                            \
    break;                                                                  \
  }                                                                         \
  case 2 * K + 1: {                                                         \
    using Sh = MultiShape<double, K>;                                       \
    out[0] = Sh::c1; out[1] = Sh::c2; out[2] = Sh::threads;                 \
    out[3] = (long long)Sh::shared_bytes(steps);                            \
    break;                                                                  \
  }
    OSC_SHAPE(1) OSC_SHAPE(2) OSC_SHAPE(3) OSC_SHAPE(4) OSC_SHAPE(5)
    OSC_SHAPE(6)
#undef OSC_SHAPE
  }
}
void primal_f64(const double* p, const int* nl, const double* e,
                const double* dens, const double* dist, double* out, int n) {
  primal<double>(p, nl, e, dens, dist, out, n);
}
void dual1_f64(const double* p, const double* dp, const int* nl,
               const double* e, const double* dens, const double* dist,
               double* out, double* dout, int n) {
  dual<double, 1>(p, dp, nl, e, dens, dist, out, dout, n);
}
void dual3_f64(const double* p, const double* dp, const int* nl,
               const double* e, const double* dens, const double* dist,
               double* out, double* dout, int n) {
  dual<double, 3>(p, dp, nl, e, dens, dist, out, dout, n);
}
void dual6_f64(const double* p, const double* dp, const int* nl,
               const double* e, const double* dens, const double* dist,
               double* out, double* dout, int n) {
  dual<double, 6>(p, dp, nl, e, dens, dist, out, dout, n);
}
long long count_ops(int k, const double* p, int nl, double e,
                    const double* dens, const double* dist) {
  switch (k) {
    case 0: return count<0>(p, nl, e, dens, dist);
    case 1: return count<1>(p, nl, e, dens, dist);
    case 2: return count<2>(p, nl, e, dens, dist);
    case 3: return count<3>(p, nl, e, dens, dist);
    case 4: return count<4>(p, nl, e, dens, dist);
    case 5: return count<5>(p, nl, e, dens, dist);
    case 6: return count<6>(p, nl, e, dens, dist);
  }
  return -1;
}
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a C++ compiler to build the kernel source for the"
                    " host")
    d = tmp_path_factory.mktemp("osc_chain_host")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    lib_path = d / "libharness.so"
    csrc = os.path.dirname(chain._CSRC)
    subprocess.run(
        [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", csrc, "-o",
         str(lib_path), str(src)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.primal_f64.argtypes = [p] * 6 + [i]
    lib.dual1_f64.argtypes = [p] * 8 + [i]
    lib.dual3_f64.argtypes = [p] * 8 + [i]
    lib.dual6_f64.argtypes = [p] * 8 + [i]
    lib.tiles_multi_f64.argtypes = [i, i, i, p, p, p, i] + [p] * 7 + [i] * 3
    lib.multi_shape.argtypes = [i, i, i, p]
    lib.count_ops.argtypes = [i, p, i, ctypes.c_double, p, p]
    lib.tile_shape.argtypes = [p]
    lib.tiles_primal_f64.argtypes = [p, p, i] + [p] * 6 + [i, i]
    lib.tiles_tangent_f64.argtypes = [p, p, p, i] + [p] * 6 + [i, i]
    lib.count_ops.restype = ctypes.c_longlong
    return lib


def _prem_geometry(n, seed=3):
    """PREM-12 chains (the flagship's Earth model) at random energies and
    zenith angles."""
    rng = np.random.RandomState(seed)
    layers = Layers("osc/PREM_12layer.dat", 2.0, 20.0)
    layers.setElecFrac(0.4656, 0.4656, 0.4957)
    layers.calcLayers(rng.uniform(-1, 1, n))
    shape = (n, layers.max_layers)
    return chain.prepare_chain_geometry(
        10 ** rng.uniform(0, 3, n), layers.density.reshape(shape),
        layers.distance.reshape(shape), dtype=torch.float64, device="cpu",
    )


def _grid_geometry(kind):
    """The flagship's Earth model on a 20x20 (energy, coszen) grid of bin
    centres (1-1000 GeV log, coszen -1..1), or random chains of 0..8 layers
    with zero-length gaps, some with no real layer."""
    if kind == "prem20x20":
        e_edges = np.logspace(0, 3, 21)
        z_edges = np.linspace(-1, 1, 21)
        e_c = np.sqrt(e_edges[:-1] * e_edges[1:])
        z_c = 0.5 * (z_edges[:-1] + z_edges[1:])
        energy, coszen = (x.ravel() for x in np.meshgrid(e_c, z_c,
                                                         indexing="ij"))
        layers = Layers("osc/PREM_12layer.dat", 2.0, 20.0)
        layers.setElecFrac(0.4656, 0.4656, 0.4957)
        layers.calcLayers(coszen)
        shape = (energy.size, layers.max_layers)
        dens = layers.density.reshape(shape)
        dist = layers.distance.reshape(shape)
    else:
        rng = np.random.RandomState(17)
        n = 300
        energy = 10 ** rng.uniform(0, 3, n)
        dens = rng.uniform(1, 12, (n, 8))
        dist = rng.uniform(50, 1000, (n, 8))
        dist[rng.uniform(size=(n, 8)) < 0.3] = 0.0  # gaps
        dist[:40] = 0.0  # points with no real layer
    return chain.prepare_chain_geometry(energy, dens, dist,
                                        dtype=torch.float64, device="cpu")


def _tile_args(geom):
    t = geom["tiles"]
    return (t["tile"], t["tile"].shape[0], t["point_step"], t["step_point"],
            t["rho"], t["dx"], geom["e"])


def _ptrs_and_ints(*args):
    return [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]


def _pack(nubar):
    theta = torch.tensor(THETA, dtype=torch.float64)
    jac = torch.func.jacfwd(lambda t: chain.theta_to_pvec(t, nubar))(theta)
    return chain.theta_to_pvec(theta, nubar), jac.T.contiguous()


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _serial_dual(host_lib, geom, pvec, dpvecs):
    """chain_point over Dual<double, K> for K = 3 or 6 directions, point by
    point: the primal (2, 3, N) and the tangents (K, 2, 3, N)."""
    k, n = dpvecs.shape[0], geom["e"].shape[0]
    out = torch.empty((2, 3, n), dtype=torch.float64)
    dout = torch.empty((k, 2, 3, n), dtype=torch.float64)
    fn = {3: host_lib.dual3_f64, 6: host_lib.dual6_f64}[k]
    fn(*_ptrs(pvec, dpvecs, geom["nl"], geom["e"], geom["dens"], geom["dist"],
              out, dout), n)
    return out, dout


@pytest.mark.parametrize("nubar", [1, -1])
def test_source_primal_matches_reference(host_lib, nubar):
    """The host build of the kernel's math against the plain version (fp64:
    both are the same algorithm; only operation order differs)."""
    geom = _prem_geometry(500)
    pvec, _ = _pack(nubar)
    args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
    n = geom["e"].shape[0]
    out = torch.empty((2, 3, n), dtype=torch.float64)
    host_lib.primal_f64(*_ptrs(pvec, geom["nl"], geom["e"], geom["dens"],
                               geom["dist"], out), n)
    want = chain.chain_probs_reference(pvec, *args)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("nubar", [1, -1])
def test_source_dual6_matches_jvp(host_lib, nubar):
    """Dual<double, 6> along all six pack-Jacobian directions against the
    forward-mode derivative of the plain version, relative to each
    direction's largest tangent; its directions equal Dual<double, 3>'s bit
    for bit (fp64)."""
    geom = _prem_geometry(200, seed=5)
    pvec, dirs = _pack(nubar)
    args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
    n = geom["e"].shape[0]
    want_p, want_t = chain.chain_multitangent_reference(pvec, dirs, *args)
    out, dout = _serial_dual(host_lib, geom, pvec, dirs)
    np.testing.assert_allclose(out.numpy(), want_p.numpy(), rtol=0,
                               atol=1e-12)
    scale = want_t.abs().amax(dim=(1, 2, 3), keepdim=True)
    assert float(((dout - want_t).abs() / scale).max()) < 1e-10
    out3, dout3 = _serial_dual(host_lib, geom, pvec, dirs[ACTIVE].contiguous())
    assert torch.equal(out3, out)
    assert torch.equal(dout3, dout[ACTIVE])


@pytest.mark.parametrize("nubar", [1, -1])
def test_source_dual_matches_jvp(host_lib, nubar):
    """Dual<double, 1> and Dual<double, 3> against the forward-mode
    derivative of the plain version, along the flagship's active pack
    directions; relative to each direction's largest tangent (fp64)."""
    geom = _prem_geometry(500, seed=4)
    pvec, dirs = _pack(nubar)
    args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
    n = geom["e"].shape[0]
    dpvecs = dirs[ACTIVE].contiguous()
    want_p, want_t = chain.chain_multitangent_reference(pvec, dpvecs, *args)
    out = torch.empty((2, 3, n), dtype=torch.float64)
    dout = torch.empty((3, 2, 3, n), dtype=torch.float64)
    host_lib.dual3_f64(*_ptrs(pvec, dpvecs, geom["nl"], geom["e"],
                              geom["dens"], geom["dist"], out, dout), n)
    np.testing.assert_allclose(out.numpy(), want_p.numpy(), rtol=0,
                               atol=1e-12)
    scale = want_t.abs().amax(dim=(1, 2, 3), keepdim=True)
    assert float(((dout - want_t).abs() / scale).max()) < 1e-10
    one = torch.empty((2, 3, n), dtype=torch.float64)
    for j in range(3):
        host_lib.dual1_f64(*_ptrs(pvec, dpvecs[j].contiguous(), geom["nl"],
                                  geom["e"], geom["dens"], geom["dist"], out,
                                  one), n)
        assert torch.equal(one, dout[j])


@pytest.mark.parametrize("k", range(chain.MAX_TANGENTS + 1))
def test_operation_counts(host_lib, k):
    """chain_operations(k) is what chain_point does: per point with no
    layer, and per layer of nonzero length."""
    pvec, _ = _pack(1)
    dens = np.full(4, 3.0)
    dist = np.full(4, 500.0)
    counts = [
        host_lib.count_ops(k, pvec.data_ptr(), nl, 10.0, dens.ctypes.data,
                           dist.ctypes.data)
        for nl in (0, 1, 3)
    ]
    per_point, per_step = chain.chain_operations(k)
    assert counts == [per_point, per_point + per_step,
                      per_point + 3 * per_step]


def test_tile_shape_matches_source(host_lib):
    """The tile shape the host cuts (chain.TILE_STEPS, TILE_POINTS) is the
    kernel's (kTileSteps, kTilePoints), with a thread per step and two per
    point, and the most lanes of a launch is the wrappers'. The
    multitangent's tiles of the same shape fit a block's 227 KB
    of shared memory for every K in both float types; its chunks of
    directions are within 1..K, and it has a thread per step and chunk."""
    shape = (ctypes.c_int * 4)()
    host_lib.tile_shape(ctypes.addressof(shape))
    steps, points, threads, lanes = shape
    assert (steps, points) == (chain.TILE_STEPS, chain.TILE_POINTS)
    assert lanes == chain.MAX_LANES
    assert threads >= steps and threads >= 2 * points
    for dtype in (torch.float32, torch.float64):
        size = torch.empty((), dtype=dtype).element_size()
        for k in range(1, chain.MAX_TANGENTS + 1):
            got = (ctypes.c_longlong * 4)()
            host_lib.multi_shape(int(dtype == torch.float64), k, steps,
                                 ctypes.addressof(got))
            c1, c2, multi_threads, nbytes = got
            assert 1 <= c1 <= k and 1 <= c2 <= k
            assert multi_threads == steps * -(-k // c1) <= 1024
            assert size * steps * 18 * (1 + k) < nbytes <= 232448


@pytest.mark.parametrize("kind", ["prem20x20", "gaps"])
@pytest.mark.parametrize("nubar", [1, -1])
def test_source_tile_pass_primal(host_lib, kind, nubar):
    """The tile pass (phases 0-2 over the tile table) against the plain
    version to 1e-12 and against the serial chain_point to 1e-14 (fp64)."""
    geom = _grid_geometry(kind)
    pvec, _ = _pack(nubar)
    n = geom["e"].shape[0]
    got = torch.full((2, 3, n), np.nan, dtype=torch.float64)
    host_lib.tiles_primal_f64(*_ptrs_and_ints(pvec, *_tile_args(geom), got,
                                              n, 1))
    args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
    want = chain.chain_probs_reference(pvec, *args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    serial = torch.empty((2, 3, n), dtype=torch.float64)
    host_lib.primal_f64(*_ptrs(pvec, geom["nl"], geom["e"], geom["dens"],
                               geom["dist"], serial), n)
    np.testing.assert_allclose(got.numpy(), serial.numpy(), rtol=0,
                               atol=1e-14)


@pytest.mark.parametrize("kind", ["prem20x20", "gaps"])
@pytest.mark.parametrize("nubar", [1, -1])
def test_source_tile_pass_tangent(host_lib, kind, nubar):
    """The dual tile pass along each of the flagship's active pack
    directions against the forward-mode derivative of the plain version to
    1e-12 of the direction's largest tangent, and against the serial
    Dual<double, 1> chain_point to 1e-14 of it (fp64)."""
    geom = _grid_geometry(kind)
    pvec, dirs = _pack(nubar)
    n = geom["e"].shape[0]
    args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
    primal = torch.empty((2, 3, n), dtype=torch.float64)
    serial = torch.empty((2, 3, n), dtype=torch.float64)
    for k in ACTIVE:
        d = dirs[k].contiguous()
        got = torch.full((2, 3, n), np.nan, dtype=torch.float64)
        host_lib.tiles_tangent_f64(*_ptrs_and_ints(pvec, d, *_tile_args(geom),
                                                   got, n, 1))
        want = chain.chain_tangent_reference(pvec, d, *args)
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= 1e-12 * scale
        host_lib.dual1_f64(*_ptrs(pvec, d, geom["nl"], geom["e"],
                                  geom["dens"], geom["dist"], primal, serial),
                           n)
        assert float((got - serial).abs().max()) <= 1e-14 * scale


# (K, c1, c2, steps a tile): K directions in chunks of c1 (phase 1) and c2
# (phase 2), c1 = 0 for the chunks the kernel ships with; tables cut to the
# kernel's own tile size or to a smaller one
_MULTI_SHAPES = [
    (3, 0, 0, None), (6, 0, 0, None), (1, 0, 0, 40), (2, 0, 0, 40),
    (4, 0, 0, 40), (5, 0, 0, 40),
    (3, 3, 3, 128), (3, 1, 1, 64), (3, 2, 2, 128), (3, 1, 6, 24),
    (6, 6, 6, 128), (6, 2, 1, 64), (6, 3, 3, 24), (6, 4, 4, 128),
    (6, 1, 6, 64), (6, 6, 1, 64), (5, 2, 2, 64), (5, 3, 1, 128),
]


@pytest.mark.parametrize("kind", ["prem20x20", "gaps"])
@pytest.mark.parametrize("k,c1,c2,steps", _MULTI_SHAPES)
def test_source_tile_pass_multitangent(host_lib, kind, k, c1, c2, steps):
    """The multitangent tile pass (the tile phases with K directions split
    into chunks) against the plain version: primal to 1e-12, each tangent to
    1e-12 of its direction's largest; and, for K = 3 and K = 6, against the
    serial chain_point over Dual<double, K> to 1e-14 (fp64)."""
    geom = _grid_geometry(kind)
    pvec, dirs = _pack(1 if (k + c1) % 2 else -1)
    dpvecs = dirs[ACTIVE if k == 3 else list(range(k))].contiguous()
    n = geom["e"].shape[0]
    args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
    if steps is None:
        steps = chain.TILE_STEPS
    tiles = chain.tile_table(
        geom["dens"].numpy().T, geom["dist"].numpy().T, dtype=torch.float64,
        device="cpu", steps=steps)
    assert int(tiles["tile"][:, 3].max()) <= steps
    got_p = torch.full((2, 3, n), np.nan, dtype=torch.float64)
    got_t = torch.full((k, 2, 3, n), np.nan, dtype=torch.float64)
    rc = host_lib.tiles_multi_f64(k, c1, c2, *_ptrs_and_ints(
        pvec, dpvecs, tiles["tile"], tiles["tile"].shape[0],
        tiles["point_step"], tiles["step_point"], tiles["rho"], tiles["dx"],
        geom["e"], got_p, got_t, n, steps, 1))
    assert rc == 0
    want_p, want_t = chain.chain_multitangent_reference(pvec, dpvecs, *args)
    np.testing.assert_allclose(got_p.numpy(), want_p.numpy(), rtol=0,
                               atol=1e-12)
    scale = want_t.abs().amax(dim=(1, 2, 3), keepdim=True)
    assert float(scale.min()) > 0
    assert float(((got_t - want_t).abs() / scale).max()) <= 1e-12
    if k in (3, 6):
        serial_p, serial_t = _serial_dual(host_lib, geom, pvec, dpvecs)
        np.testing.assert_allclose(got_p.numpy(), serial_p.numpy(), rtol=0,
                                   atol=1e-14)
        assert float(((got_t - serial_t).abs() / scale).max()) <= 1e-14


# three lanes of theta: nominal and two others (both signs of dm31)
LANE_THETAS = [
    THETA,
    [0.6, 0.14, 0.70, 1.0, 7.5e-5, -2.4e-3],
    [0.58, 0.16, 0.92, 0.2, 7.2e-5, 2.6e-3],
]


@pytest.mark.parametrize("kind", ["prem20x20", "gaps"])
@pytest.mark.parametrize("which", ["primal", "tangent", "multitangent"])
def test_source_tile_pass_lanes(host_lib, kind, which):
    """B = 3 lanes through one tile pass, with the kernels' lane offsets
    (lane_slices): each lane equals the single-lane pass at its own pack
    bit for bit (the same code in the same order), and the lanes together
    match the plain version's lane axis (primal to 1e-12, tangents to
    1e-12 of their direction's largest; fp64). Outputs start as NaN, so a
    slice that no lane writes shows."""
    geom = _grid_geometry(kind)
    n = geom["e"].shape[0]
    theta = torch.tensor(LANE_THETAS, dtype=torch.float64)
    pvec = chain.theta_to_pvec(theta, 1).contiguous()  # (3, 57)
    jac = chain.pack_jacobian(theta, 1)  # (3, 57, 6)
    dirs = jac[..., ACTIVE].transpose(1, 2).contiguous()  # (3, 3, 57)
    args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
    k = {"primal": 0, "tangent": 1, "multitangent": 3}[which]
    dp = dirs[:, 1].contiguous() if k == 1 else dirs

    def run(p, d, lanes):
        out = torch.full((lanes, 2, 3, n), np.nan, dtype=torch.float64)
        dout = torch.full((lanes, max(k, 1), 2, 3, n), np.nan,
                          dtype=torch.float64)
        if k == 0:
            host_lib.tiles_primal_f64(*_ptrs_and_ints(
                p, *_tile_args(geom), out, n, lanes))
            return out, None
        if k == 1:
            host_lib.tiles_tangent_f64(*_ptrs_and_ints(
                p, d, *_tile_args(geom), dout, n, lanes))
            return None, dout[:, 0]
        t = geom["tiles"]
        rc = host_lib.tiles_multi_f64(k, 0, 0, *_ptrs_and_ints(
            p, d, t["tile"], t["tile"].shape[0], t["point_step"],
            t["step_point"], t["rho"], t["dx"], geom["e"], out, dout, n,
            chain.TILE_STEPS, lanes))
        assert rc == 0
        return out, dout

    got_p, got_t = run(pvec, dp, 3)
    for b in range(3):
        one_p, one_t = run(pvec[b].contiguous(), dp[b].contiguous(), 1)
        if got_p is not None:
            assert torch.equal(got_p[b], one_p[0])
        if got_t is not None:
            assert torch.equal(got_t[b], one_t[0])
    if k == 0:
        want = chain.chain_probs_reference(pvec, *args)
        np.testing.assert_allclose(got_p.numpy(), want.numpy(), rtol=0,
                                   atol=1e-12)
        return
    if k == 1:
        want_t = chain.chain_tangent_reference(pvec, dp, *args)[:, None]
        got_t = got_t[:, None]
    else:
        want_p, want_t = chain.chain_multitangent_reference(pvec, dp, *args)
        np.testing.assert_allclose(got_p.numpy(), want_p.numpy(), rtol=0,
                                   atol=1e-12)
    scale = want_t.abs().amax(dim=(2, 3, 4), keepdim=True)
    assert float(scale.min()) > 0
    assert float(((got_t - want_t).abs() / scale).max()) <= 1e-12
