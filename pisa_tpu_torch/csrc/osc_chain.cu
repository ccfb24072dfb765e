// Earth-layer chain propagation of three-flavour neutrino oscillations for
// NVIDIA Hopper (sm_90a): the primal, its forward-mode tangent along one
// direction of the parameter pack, and the primal with K tangents in one
// pass.
//
// Replaces the TPU kernels of pisa_tpu/ops/osc/pallas_chain.py:
// - _chain_kernel (math in _chain_block_math, _vacuum_picks, _init_carry,
//   _layer_T, _apply_T, _final_probs_flat) -> tile_kernel<S, 0>;
// - _chain_tangent_kernel (an in-body jax.jvp of _chain_block_math)
//   -> tile_kernel<S, 1>, with no primal output;
// - _chain_multitangent_kernel (_chain_block_math_multitangent: the primal
//   plus K tangents, each layer step linearized once)
//   -> tile_multi_kernel<S, K>, K = 1..6.
//
// The math. For each point: start from the nu_e and nu_mu states rotated to
// the mass basis (initial_state); for each of the point's layers of nonzero
// length, form the mass-basis Hamiltonian H = diag(0, dm21, dm31)/2E +
// a(rho) M_eff + L_eff, solve its eigenvalues in closed form (ordered to
// match the vacuum ones), and build the Barger et al. eq. 10 amplitude T
// from two spectral projectors (layer_T); apply it to both states (apply_T);
// finally rotate back with U and write |amplitude|^2 as the (2, 3, N)
// nu_e / nu_mu initial-state rows (flavour_probs).
//
// With T = float/double this is the primal. With T = Dual<S, K> (a value and
// K tangent components, forward-mode automatic differentiation written out)
// the same source gives the tangents: the pack is read as duals whose
// tangent parts are the K directions, the geometry (energy, densities,
// distances) stays plain S with zero tangent, comparisons (max/min, dx > 0)
// decide on the value part, and the vacuum-matched eigenvalue picks are
// computed from the values only, so they carry no tangent
// (pallas_chain.py:199-203).
//
// What bounds them on the card: latency and transcendentals, not memory. A
// primal layer step (layer_T) is ~470 flops with two sqrt, an rsqrt, an
// atan2, a division and three sincos; a K = 1 dual step ~1,430; applying T
// to a state is 36 flops (108 for a dual). The flagship grid has 279,600
// real layer steps over 40,000 points, 7 per point on average and 24 at
// most. HBM traffic is small: the steps' (rho, dx) in, 6 x (1 + K) x N
// results out, a few MB that stay in L2.
//
// All three kernels are layer-parallel tiles. A layer step's T depends on
// the pack, the point's energy and the layer's (rho, dx), never on the
// state, so the chain dependence is only the cheap v <- T v. One thread per
// point, the first design, ran each chain serially: the kernel took as long
// as its longest chains (24 steps of ~470 / ~1,430 dependent operations),
// while most threads finished after ~7 steps, and the 157 blocks left the
// card nearly empty (the fp32 tangent, at 168 registers, ran 1 block per SM
// in two waves). The tile design (tile_kernel: the primal and the tangent):
// - the host cuts the points, in the chain-length sort, into tiles of at
//   most kTileSteps real steps and kTilePoints points, never splitting a
//   point, and compacts each point's real steps in chain order into flat
//   (rho, dx) arrays (ops/osc/chain.py:tile_table, once at set-up);
// - one block of kTileThreads per tile, in three phases separated by
//   __syncthreads(): (0) one thread per point computes the vacuum picks
//   into shared memory; (1) one thread per step builds T (and dT) into
//   shared memory, structure-of-arrays so a warp's stores hit consecutive
//   banks; (2) one thread per (point, initial flavour) walks the point's
//   steps in order, v <- T v (and dv <- dT v + T dv, by the same dual
//   arithmetic as chain_point), then writes P = |U v|^2 (and its tangent);
// - the critical path drops from 24 full steps to one step plus 24 small
//   matrix-vector products, and ~2,300 short blocks fill the card;
// - kTileSteps = 128 keeps the fp64 tangent's T and dT (128 x 36 doubles,
//   36 KB) under the 48 KB of static shared memory and leaves blocks small,
//   so that several resident blocks interleave their phases on an SM.
//
// The multitangent (tile_multi_kernel<S, K>) is the same three phases with
// K directions. Each step is linearized once: phase 1 stores T and its K
// tangents dT_k, and phase 2 applies them to v and its tangents
// (dv_k <- dT_k v + T dv_k). What grows with K, and what the design does:
// - shared memory: T and K dT of a tile are 128 x 18 x (1 + K) scalars, up
//   to 129 KB (fp64, K = 6), so the block's memory is dynamic (above 48 KB
//   it is opted into once per kernel) and carved by hand (TileMem);
// - registers in phase 1: layer_T over a dual of K directions holds every
//   intermediate 1 + K times, so the directions are cut into chunks of at
//   most 3, a thread per (step, chunk); a later chunk computes the primal
//   part again. With 3 the fp64 instances stay within 255 registers and
//   spill at most 8 bytes (K = 3, 5, 6); the block has a thread per step
//   and chunk (128 for K <= 3, 256 above);
// - the chain walk: a thread per (point, initial flavour, direction), each
//   walking v with one tangent: short threads, K times as many, instead of
//   one thread carrying 6 (1 + K) complex registers along 24 steps.
// Each phase is a loop of the block's threads over its work items. The
// per-direction arithmetic is the tangent kernel's, bit for bit.
//
// chain_point, a point's whole chain in one thread over any scalar type, is
// the arithmetic reference: the host tests
// (tests/test_torch_chain_source.py) hold the tile passes against it.
//
// Lanes: one launch serves B independent packs (the batched fits' lanes,
// what jax.vmap adds to a pallas_call as a grid axis): blockIdx.y is the
// lane, each lane's pack, directions and outputs are contiguous slices
// (lane_slices, 64-bit offsets), and the geometry and the tile table are
// shared by every lane. A block is unchanged: it rebuilds T from its lane's
// pack. B = 1 is the single-pack launch, bit for bit.
//
// The kernels read the pack and its tangent directions from device
// pointers into shared memory at block start: no host sync, so a launch can
// be captured in a CUDA graph. Real atan2/sincos/rsqrt, no fast-math: the
// layer phases reach tens of radians, where __sinf/__cosf lose their range
// reduction. The TPU kernels' 8x128 blocking, BLOCK_ROWS/UNROLL knobs, atan
// polynomial and planar output variants are TPU workarounds and are not
// carried over.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libosc_chain.so osc_chain.cu
// Defining OSC_CHAIN_PRIMAL, OSC_CHAIN_TANGENT or OSC_CHAIN_MULTITANGENT
// compiles only that kernel's entry points (the build compiles the three
// parts in parallel); with none defined, all three are compiled.
// Bound through ctypes (pisa_tpu_torch/ops/osc/chain.py); each launch entry
// point returns cudaGetLastError() after its launch.

#include <cmath>
#include <cstddef>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define OSC_HD __host__ __device__ __forceinline__
#else
#define OSC_HD inline
#endif

#if !defined(OSC_CHAIN_PRIMAL) && !defined(OSC_CHAIN_TANGENT) && \
    !defined(OSC_CHAIN_MULTITANGENT)
#define OSC_CHAIN_PRIMAL
#define OSC_CHAIN_TANGENT
#define OSC_CHAIN_MULTITANGENT
#endif

namespace osc_chain {

constexpr int kPack = 57;
constexpr int kMaxTangents = 6;  // multitangent K is dispatched to 1..6
static_assert(kMaxTangents == 6, "with_multi dispatches K = 1..6");
constexpr double kTwoSqrt2GF = 1.52588e-4;  // 2 sqrt(2) G_F, eV^2 cm^3/(mol GeV)
constexpr double kHbarC = 2.534;            // (1/2)/(hbar c), GeV/(eV^2 km)
constexpr double kHalfSqrt3 = 0.8660254037844386;

// Tile shape of tile_kernel; ops/osc/chain.py:TILE_STEPS and TILE_POINTS
// must match (tests/test_torch_chain_source.py checks).
constexpr int kTileSteps = 128;   // most real layer steps in one tile
constexpr int kTilePoints = 64;   // most points in one tile
constexpr int kTileThreads = 128;  // threads of a tile block
static_assert(kTileThreads >= kTileSteps && kTileThreads >= 2 * kTilePoints,
              "phase 1 needs a thread per step, phase 2 two per point");

// -- precision-dispatched math (device intrinsics on the card, std on host) --
OSC_HD float osc_sqrt(float x) { return sqrtf(x); }
OSC_HD double osc_sqrt(double x) { return sqrt(x); }
OSC_HD float osc_atan2(float y, float x) { return atan2f(y, x); }
OSC_HD double osc_atan2(double y, double x) { return atan2(y, x); }
OSC_HD float osc_fabs(float x) { return fabsf(x); }
OSC_HD double osc_fabs(double x) { return fabs(x); }
OSC_HD float osc_rsqrt(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}
OSC_HD double osc_rsqrt(double x) {
#ifdef __CUDA_ARCH__
  return rsqrt(x);
#else
  return 1.0 / sqrt(x);
#endif
}
OSC_HD void osc_sincos(float x, float* s, float* c) {
#ifdef __CUDA_ARCH__
  sincosf(x, s, c);
#else
  *s = sinf(x);
  *c = cosf(x);
#endif
}
OSC_HD void osc_sincos(double x, double* s, double* c) {
#ifdef __CUDA_ARCH__
  sincos(x, s, c);
#else
  *s = sin(x);
  *c = cos(x);
#endif
}
OSC_HD float value(float x) { return x; }
OSC_HD double value(double x) { return x; }
template <typename T>
OSC_HD T osc_max(T a, T b) { return value(a) > value(b) ? a : b; }
template <typename T>
OSC_HD T osc_min(T a, T b) { return value(a) < value(b) ? a : b; }

// -- forward-mode dual numbers: value v and K tangent components d[k] --------
template <typename S, int K>
struct Dual {
  S v;
  S d[K];
  OSC_HD Dual() {}
  OSC_HD Dual(S x) : v(x) {
    for (int k = 0; k < K; ++k) d[k] = S(0);
  }
};
template <typename S, int K>
OSC_HD S value(const Dual<S, K>& x) { return x.v; }

template <typename S, int K>
OSC_HD Dual<S, K> operator-(const Dual<S, K>& a) {
  Dual<S, K> r;
  r.v = -a.v;
  for (int k = 0; k < K; ++k) r.d[k] = -a.d[k];
  return r;
}
template <typename S, int K>
OSC_HD Dual<S, K> operator+(const Dual<S, K>& a, const Dual<S, K>& b) {
  Dual<S, K> r;
  r.v = a.v + b.v;
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
template <typename S, int K>
OSC_HD Dual<S, K> operator+(const Dual<S, K>& a, S b) {
  Dual<S, K> r = a;
  r.v = a.v + b;
  return r;
}
template <typename S, int K>
OSC_HD Dual<S, K> operator+(S a, const Dual<S, K>& b) { return b + a; }
template <typename S, int K>
OSC_HD Dual<S, K> operator-(const Dual<S, K>& a, const Dual<S, K>& b) {
  Dual<S, K> r;
  r.v = a.v - b.v;
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
template <typename S, int K>
OSC_HD Dual<S, K> operator-(const Dual<S, K>& a, S b) {
  Dual<S, K> r = a;
  r.v = a.v - b;
  return r;
}
template <typename S, int K>
OSC_HD Dual<S, K> operator-(S a, const Dual<S, K>& b) {
  Dual<S, K> r;
  r.v = a - b.v;
  for (int k = 0; k < K; ++k) r.d[k] = -b.d[k];
  return r;
}
template <typename S, int K>
OSC_HD Dual<S, K> operator*(const Dual<S, K>& a, const Dual<S, K>& b) {
  Dual<S, K> r;
  r.v = a.v * b.v;
  for (int k = 0; k < K; ++k) r.d[k] = a.v * b.d[k] + a.d[k] * b.v;
  return r;
}
template <typename S, int K>
OSC_HD Dual<S, K> operator*(const Dual<S, K>& a, S b) {
  Dual<S, K> r;
  r.v = a.v * b;
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] * b;
  return r;
}
template <typename S, int K>
OSC_HD Dual<S, K> operator*(S a, const Dual<S, K>& b) { return b * a; }
template <typename S, int K>
OSC_HD Dual<S, K> operator/(const Dual<S, K>& a, const Dual<S, K>& b) {
  Dual<S, K> r;
  const S inv = S(1) / b.v;
  r.v = a.v * inv;
  for (int k = 0; k < K; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) * inv;
  return r;
}
template <typename S, int K>
OSC_HD Dual<S, K> operator/(const Dual<S, K>& a, S b) {
  Dual<S, K> r;
  r.v = a.v / b;
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] / b;
  return r;
}
template <typename S, int K>
OSC_HD Dual<S, K> operator/(S a, const Dual<S, K>& b) {
  Dual<S, K> r;
  const S inv = S(1) / b.v;
  r.v = a * inv;
  for (int k = 0; k < K; ++k) r.d[k] = -r.v * b.d[k] * inv;
  return r;
}
// sqrt and rsqrt have an infinite derivative at 0, as in jax.jvp: the
// clamped discriminants stay positive off exact eigenvalue degeneracies
template <typename S, int K>
OSC_HD Dual<S, K> osc_sqrt(const Dual<S, K>& x) {
  Dual<S, K> r;
  r.v = osc_sqrt(x.v);
  const S g = S(0.5) / r.v;
  for (int k = 0; k < K; ++k) r.d[k] = x.d[k] * g;
  return r;
}
template <typename S, int K>
OSC_HD Dual<S, K> osc_rsqrt(const Dual<S, K>& x) {
  Dual<S, K> r;
  r.v = osc_rsqrt(x.v);
  const S g = S(-0.5) * r.v * r.v * r.v;
  for (int k = 0; k < K; ++k) r.d[k] = x.d[k] * g;
  return r;
}
template <typename S, int K>
OSC_HD Dual<S, K> osc_atan2(const Dual<S, K>& y, const Dual<S, K>& x) {
  Dual<S, K> r;
  r.v = osc_atan2(y.v, x.v);
  const S inv = S(1) / (x.v * x.v + y.v * y.v);
  for (int k = 0; k < K; ++k) r.d[k] = (x.v * y.d[k] - y.v * x.d[k]) * inv;
  return r;
}
template <typename S, int K>
OSC_HD void osc_sincos(const Dual<S, K>& x, Dual<S, K>* s, Dual<S, K>* c) {
  S sv, cv;
  osc_sincos(x.v, &sv, &cv);
  s->v = sv;
  c->v = cv;
  for (int k = 0; k < K; ++k) {
    s->d[k] = cv * x.d[k];
    c->d[k] = -sv * x.d[k];
  }
}

// A scalar's components in memory (the tile kernels' shared-memory t and
// their outputs): the value, then the tangents of all k_all directions, each
// `stride` apart. A Dual<S, C> holds the C directions from `first` on, a
// chunk of the k_all: its value is stored by the chunk with first == 0,
// and the directions past k_all (the last chunk's padding) are skipped on a
// store and read as zero.
template <typename S>
OSC_HD void put_parts(S* dst, int stride, S x, int first, int k_all) {
  dst[0] = x;
}
template <typename S, int C>
OSC_HD void put_parts(S* dst, int stride, const Dual<S, C>& x, int first,
                      int k_all) {
  if (first == 0) dst[0] = x.v;
  for (int d = 0; d < C; ++d)
    if (first + d < k_all) dst[(1 + first + d) * stride] = x.d[d];
}
template <typename S>
OSC_HD void get_parts(const S* src, int stride, S* x, int first, int k_all) {
  *x = src[0];
}
template <typename S, int C>
OSC_HD void get_parts(const S* src, int stride, Dual<S, C>* x, int first,
                      int k_all) {
  x->v = src[0];
  for (int d = 0; d < C; ++d)
    x->d[d] = first + d < k_all ? src[(1 + first + d) * stride] : S(0);
}

// -- complex arithmetic over any scalar type T (plain or dual) ---------------
template <typename T>
struct Cx {
  T re, im;
};
template <typename T>
OSC_HD Cx<T> cx(T re, T im) { return Cx<T>{re, im}; }
template <typename T>
OSC_HD Cx<T> operator+(Cx<T> a, Cx<T> b) { return cx(a.re + b.re, a.im + b.im); }
template <typename T>
OSC_HD Cx<T> operator*(Cx<T> a, Cx<T> b) {
  return cx(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}
template <typename T, typename U>
OSC_HD Cx<T> scale(Cx<T> a, U s) { return cx<T>(a.re * s, a.im * s); }
template <typename T>
OSC_HD Cx<T> conj(Cx<T> a) { return cx(a.re, -a.im); }
template <typename T>
OSC_HD T abs2(Cx<T> a) { return a.re * a.re + a.im * a.im; }

// Hermitian triangle of one spectral projector product (G - ma)(G - mb):
// real diagonal d0..d2, complex upper entries o01, o02, o12.
template <typename T>
struct Proj {
  T d0, d1, d2;
  Cx<T> o01, o02, o12;
};

// Packed parameter layout (pallas_chain.py:_unpack_params): U re/im at 0/9,
// M_eff re/im at 18/27, L_eff re/im at 36/45, dm_vac[:, 0] at 54..56.
// A pack is read through p(k): PlainPack gives scalars, DualPack gives duals
// whose tangent k is the k-th direction (K x 57, direction-major).
template <typename S>
struct PlainPack {
  using type = S;
  const S* p;
  OSC_HD S operator()(int k) const { return p[k]; }
};
template <typename S, int K>
struct DualPack {
  using type = Dual<S, K>;
  const S* p;
  const S* dp;
  OSC_HD Dual<S, K> operator()(int k) const {
    Dual<S, K> r;
    r.v = p[k];
    for (int j = 0; j < K; ++j) r.d[j] = dp[j * kPack + k];
    return r;
  }
};
// The pack type of a pass with K tangents (0: the primal) over the pack p
// and the directions dp (K x 57).
template <typename S, int K>
struct PackOf {
  using type = DualPack<S, K>;
  static OSC_HD type over(const S* p, const S* dp) { return type{p, dp}; }
};
template <typename S>
struct PackOf<S, 0> {
  using type = PlainPack<S>;
  static OSC_HD type over(const S* p, const S* dp) { return type{p}; }
};
template <typename P>
OSC_HD Cx<typename P::type> pU(const P& p, int i, int j) {
  return cx(p(3 * i + j), p(9 + 3 * i + j));
}
template <typename P>
OSC_HD Cx<typename P::type> pM(const P& p, int i, int j) {
  return cx(p(18 + 3 * i + j), p(27 + 3 * i + j));
}
template <typename P>
OSC_HD Cx<typename P::type> pL(const P& p, int i, int j) {
  return cx(p(36 + 3 * i + j), p(45 + 3 * i + j));
}

// Closed-form eigenvalue angle: the three roots are
// scale * (b cos(res + 2pi k/3) - c2/3) + dm00, with cos(res +- 2pi/3) by
// angle addition (2 transcendentals, not 3).
template <typename T, typename S>
OSC_HD void roots3(T scale, T b, T res, T c2, T dm00, S two_e, T m[3]) {
  T sr, cr;
  osc_sincos(res, &sr, &cr);
  const T third = T(1.0 / 3.0);
  const T h3 = T(kHalfSqrt3);
  m[0] = two_e * (scale * (b * (T(-0.5) * cr - h3 * sr) - c2 * third) + dm00);
  m[1] = two_e * (scale * (b * (T(-0.5) * cr + h3 * sr) - c2 * third) + dm00);
  m[2] = two_e * (scale * (b * cr - c2 * third) + dm00);
}

// Vacuum-matched ordering (layer-invariant; pallas_chain.py:_vacuum_picks),
// from the values of the pack only: the picks carry no tangent.
template <typename S>
OSC_HD void vacuum_picks(S dm00, S dm10, S dm20, S one_over_two_e, S two_e,
                         bool pick1[3], bool pick2[3]) {
  const S third = S(1.0 / 3.0);
  const S scale_v =
      osc_max(osc_max(osc_fabs(dm10), osc_fabs(dm20)) * one_over_two_e,
              S(1e-30));
  const S x = dm10 * one_over_two_e / scale_v;
  const S y = dm20 * one_over_two_e / scale_v;
  const S c2_v = -(x + y);
  const S p_v = x * x + y * y - x * y;
  const S q_v = (x + y) * ((x + y) * (x + y) - S(4.5) * x * y);
  const S tmp_v = osc_max(p_v * p_v * p_v - q_v * q_v, S(0));
  const S res_v = osc_atan2(osc_sqrt(tmp_v), q_v) * third;
  const S b_v = (S(2.0) * third) * osc_sqrt(p_v);
  S m_v[3];
  roots3(scale_v, b_v, res_v, c2_v, dm00, two_e, m_v);
  const S targets[3] = {dm00, dm10, dm20};
  for (int k = 0; k < 3; ++k) {
    const S d0 = osc_fabs(targets[k] - m_v[0]);
    const S d1 = osc_fabs(targets[k] - m_v[1]);
    const S d2 = osc_fabs(targets[k] - m_v[2]);
    pick1[k] = d1 < d0;
    pick2[k] = d2 < osc_min(d0, d1);
  }
}

template <typename T>
OSC_HD Proj<T> projector(T g00, T g11, T g22, Cx<T> g01, Cx<T> g02, Cx<T> g12,
                         T n01g, T n02g, T n12g, Cx<T> x01, Cx<T> x02,
                         Cx<T> x12, T ma, T mb) {
  const T a00 = g00 - ma, a11 = g11 - ma, a22 = g22 - ma;
  const T b00 = g00 - mb, b11 = g11 - mb, b22 = g22 - mb;
  Proj<T> pr;
  pr.d0 = a00 * b00 + n01g + n02g;
  pr.d1 = a11 * b11 + n01g + n12g;
  pr.d2 = a22 * b22 + n02g + n12g;
  pr.o01 = scale(g01, a00 + b11) + x01;
  pr.o02 = scale(g02, a00 + b22) + x02;
  pr.o12 = scale(g12, a11 + b22) + x12;
  return pr;
}

// Initial state a (0: nu_e, 1: nu_mu) in the mass basis: column a of
// U^dagger, v[i] = conj(U[a][i]).
template <typename P>
OSC_HD void initial_state(const P& p, int a, Cx<typename P::type> v[3]) {
  for (int i = 0; i < 3; ++i) v[i] = conj(pU(p, a, i));
}

// The amplitude t of one layer of nonzero length dx and density rho, for a
// point whose energy gives one_over_two_e = 1/2E, two_e = 2E and
// phase_s = -kHbarC/E, with the point's vacuum picks. `p` reads the pack
// (T = P::type: plain or dual); the geometry is plain S.
template <typename P, typename S>
OSC_HD void layer_T(const P& p, const bool pick1[3], const bool pick2[3],
                    S one_over_two_e, S two_e, S phase_s, S rho, S dx,
                    Cx<typename P::type> t[3][3]) {
  using T = typename P::type;
  const T third = T(1.0 / 3.0);
  const T dm00 = p(54), dm10 = p(55), dm20 = p(56);
  const Cx<T> me01 = pM(p, 0, 1), me02 = pM(p, 0, 2), me12 = pM(p, 1, 2);
  const Cx<T> le01 = pL(p, 0, 1), le02 = pL(p, 0, 2), le12 = pL(p, 1, 2);
  const T me00 = p(18), me11 = p(22), me22 = p(26);
  const T le00 = p(36), le11 = p(40), le22 = p(44);
  const S a = (S(0.5) * S(kTwoSqrt2GF)) * rho;

  // mass-basis Hamiltonian, Hermitian triangle
  const Cx<T> h01 = scale(me01, a) + le01;
  const Cx<T> h02 = scale(me02, a) + le02;
  const Cx<T> h12 = scale(me12, a) + le12;
  const T h00 = me00 * a + le00;
  const T h11 = me11 * a + le11 + dm10 * one_over_two_e;
  const T h22 = me22 * a + le22 + dm20 * one_over_two_e;

  // characteristic-polynomial coefficients, scale-normalized
  const T n01 = abs2(h01), n02 = abs2(h02), n12 = abs2(h12);
  T scale2 = osc_max(osc_max(osc_max(h00 * h00, h11 * h11), h22 * h22),
                     osc_max(osc_max(n01, n02), n12));
  scale2 = osc_max(scale2, T(1e-36));
  const T inv_s = osc_rsqrt(scale2);
  const T sc = scale2 * inv_s;
  const T inv_s2 = inv_s * inv_s;
  const T real_product_a = h01.re * (h12.re * h02.re + h12.im * h02.im) -
                           h01.im * (h12.im * h02.re - h12.re * h02.im);
  const T c2 = -(h00 + h11 + h22) * inv_s;
  const T c1 = (h00 * (h11 + h22) + h11 * h22 - n01 - n02 - n12) * inv_s2;
  const T c0 = ((h00 * n12 + h11 * n02 + h22 * n01) -
                T(2.0) * real_product_a - h00 * h11 * h22) *
               (inv_s2 * inv_s);
  const T pp = osc_max(c2 * c2 - T(3.0) * c1, T(0));
  const T qq = T(-13.5) * c0 - c2 * c2 * c2 + T(4.5) * c1 * c2;
  const T tmp = osc_max(
      T(27.0) * (T(0.25) * c1 * c1 * (pp - c1) + c0 * (qq + T(6.75) * c0)),
      T(0));
  const T res = osc_atan2(osc_sqrt(tmp), qq) * third;
  const T b = (T(2.0) * third) * osc_sqrt(pp);
  T m_u[3];
  roots3(sc, b, res, c2, dm00, two_e, m_u);
  T m[3];
  for (int k = 0; k < 3; ++k)
    m[k] = pick2[k] ? m_u[2] : (pick1[k] ? m_u[1] : m_u[0]);

  // Barger eq. 10 over the 2E-scaled Hamiltonian G via two projectors:
  // T = I + (e^{i ar1} - 1) inv1 Pr1 + (e^{i ar2} - 1) inv2 Pr2
  const T g00 = h00 * two_e, g11 = h11 * two_e, g22 = h22 * two_e;
  const Cx<T> g01 = scale(h01, two_e), g02 = scale(h02, two_e),
              g12 = scale(h12, two_e);
  const T n01g = abs2(g01), n02g = abs2(g02), n12g = abs2(g12);
  const Cx<T> x01 = g02 * conj(g12);
  const Cx<T> x02 = g01 * g12;
  const Cx<T> x12 = conj(g01) * g02;
  const Proj<T> pr1 = projector(g00, g11, g22, g01, g02, g12, n01g, n02g,
                                n12g, x01, x02, x12, m[0], m[2]);
  const Proj<T> pr2 = projector(g00, g11, g22, g01, g02, g12, n01g, n02g,
                                n12g, x01, x02, x12, m[0], m[1]);
  const T d01 = m[0] - m[1];
  const T d02 = m[0] - m[2];
  const T d12 = m[1] - m[2];
  const T r = T(1.0) / (d01 * d02 * d12);
  const T inv1 = -d02 * r;
  const T inv2 = d01 * r;
  const S s = phase_s * dx;
  const T ar1 = -d01 * s;
  const T ar2 = -d02 * s;
  T s1, c1p, s2, c2p;
  osc_sincos(ar1, &s1, &c1p);
  osc_sincos(ar2, &s2, &c2p);
  const Cx<T> w1 = cx((c1p - T(1.0)) * inv1, s1 * inv1);
  const Cx<T> w2 = cx((c2p - T(1.0)) * inv2, s2 * inv2);

  const Cx<T> t00 = scale(w1, pr1.d0) + scale(w2, pr2.d0);
  const Cx<T> t11 = scale(w1, pr1.d1) + scale(w2, pr2.d1);
  const Cx<T> t22 = scale(w1, pr1.d2) + scale(w2, pr2.d2);
  t[0][0] = cx(t00.re + T(1.0), t00.im);
  t[1][1] = cx(t11.re + T(1.0), t11.im);
  t[2][2] = cx(t22.re + T(1.0), t22.im);
  t[0][1] = w1 * pr1.o01 + w2 * pr2.o01;
  t[0][2] = w1 * pr1.o02 + w2 * pr2.o02;
  t[1][2] = w1 * pr1.o12 + w2 * pr2.o12;
  t[1][0] = w1 * conj(pr1.o01) + w2 * conj(pr2.o01);
  t[2][0] = w1 * conj(pr1.o02) + w2 * conj(pr2.o02);
  t[2][1] = w1 * conj(pr1.o12) + w2 * conj(pr2.o12);
}

// v <- t v
template <typename T>
OSC_HD void apply_T(const Cx<T> t[3][3], Cx<T> v[3]) {
  Cx<T> nv[3];
  for (int i = 0; i < 3; ++i)
    nv[i] = t[i][0] * v[0] + t[i][1] * v[1] + t[i][2] * v[2];
  for (int i = 0; i < 3; ++i) v[i] = nv[i];
}

// back to the flavour basis: F[b] = (U v)[b]; out[b] = |F[b]|^2
template <typename P>
OSC_HD void flavour_probs(const P& p, const Cx<typename P::type> v[3],
                          typename P::type out[3]) {
  for (int b = 0; b < 3; ++b) {
    const Cx<typename P::type> f = pU(p, b, 0) * v[0] + pU(p, b, 1) * v[1] +
                                   pU(p, b, 2) * v[2];
    out[b] = abs2(f);
  }
}

// One point's full chain, serially (the reference of the host tests). `p` reads the pack (T = P::type: plain or dual); `e` and the
// layer slabs are plain S. `dens`/`dist` point at the point's slot of layer
// 0 in the (L, N) slabs; consecutive layers are `stride` = N apart. Writes
// out[3a + b] = P(nu_a -> nu_b) for a in {e, mu}, b in {e, mu, tau}.
template <typename P, typename S>
OSC_HD void chain_point(const P& p, int nl, S e, const S* dens, const S* dist,
                        size_t stride, typename P::type out[6]) {
  using T = typename P::type;
  const S one_over_two_e = S(0.5) / e;
  const S two_e = S(2.0) * e;
  const S phase_s = -(S(1.0) / e) * S(kHbarC);

  bool pick1[3], pick2[3];
  vacuum_picks(value(p(54)), value(p(55)), value(p(56)), one_over_two_e,
               two_e, pick1, pick2);

  Cx<T> v[2][3];
  for (int a = 0; a < 2; ++a) initial_state(p, a, v[a]);

  for (int l = 0; l < nl; ++l) {
    const S dx = dist[l * stride];
    if (!(dx > S(0))) continue;  // zero-length layer: identity
    Cx<T> t[3][3];
    layer_T(p, pick1, pick2, one_over_two_e, two_e, phase_s,
            dens[l * stride], dx, t);
    for (int a2 = 0; a2 < 2; ++a2) apply_T(t, v[a2]);
  }

  for (int a = 0; a < 2; ++a) flavour_probs(p, v[a], out + 3 * a);
}

// -- the layer-parallel tile pass, one function per phase --------------------
// A tile: its first point and number of points (in the sorted point order),
// its first real step and number of steps (in the compacted step arrays);
// one row of the (n_tiles, 4) int32 table of ops/osc/chain.py:tile_table.
struct Tile {
  int first_point, n_points, first_step, n_steps;
};
OSC_HD Tile tile_at(const int* tiles, int k) {
  const int* r = tiles + 4 * k;
  return Tile{r[0], r[1], r[2], r[3]};
}

// Lane `lane`'s slices of a launch over several lanes: its pack (57,), its
// K directions (K, 57), its primal (2, 3, N) and its tangents (K, 2, 3, N),
// the lanes laid out one after another. The offsets are 64-bit: at 256
// lanes, K = 6 and N = 40,000 the tangents hold 368M elements. A null
// pointer stays null.
template <typename S>
struct LaneSlices {
  const S* pack;
  const S* dirs;
  S* out;
  S* dout;
};
template <typename S>
OSC_HD LaneSlices<S> lane_slices(const S* pvec, const S* dpvecs, S* out,
                                 S* dout, int k, int n, int lane) {
  const size_t b = static_cast<size_t>(lane);
  const size_t n6 = static_cast<size_t>(6) * static_cast<size_t>(n);
  const size_t kk = static_cast<size_t>(k);
  return LaneSlices<S>{
      pvec + b * kPack,
      dpvecs == nullptr ? nullptr : dpvecs + b * kk * kPack,
      out == nullptr ? nullptr : out + b * n6,
      dout == nullptr ? nullptr : dout + b * kk * n6};
}

// The most lanes of a launch: gridDim.y's limit
constexpr int kMaxLanes = 65535;

// Shared memory of one tile block: the pack and its K directions (zero
// directions after them where a chunk of directions reaches past K), each
// point's energy and packed vacuum picks, and the tile's steps' t with its
// K tangents, structure-of-arrays: scalar c of step s at t[c * steps + s],
// c = (2 (3 i + k) + im) (1 + K) + part for entry (i, k).
template <typename S>
struct TileMem {
  S* pack;
  S* e;
  unsigned char* picks;
  S* t;
  int steps;  // the most steps of a tile: the stride of t
};

// TileMem as one static struct: the primal's and the tangent's.
template <typename S, int K>
struct TileShared {
  S pack[kPack * (1 + K)];
  S e[kTilePoints];
  unsigned char picks[kTilePoints];
  S t[kTileSteps * 18 * (1 + K)];
  OSC_HD TileMem<S> mem() { return TileMem<S>{pack, e, picks, t, kTileSteps}; }
};

// Phase 0, once per point j < n_points: its energy and vacuum picks (bits
// 0-2: pick1, bits 3-5: pick2), from the pack's values.
template <typename S>
OSC_HD void tile_phase0(const Tile& tile, int j, const S* energy,
                        const TileMem<S>& m) {
  const S e = energy[tile.first_point + j];
  bool pick1[3], pick2[3];
  vacuum_picks(m.pack[54], m.pack[55], m.pack[56], S(0.5) / e, S(2.0) * e,
               pick1, pick2);
  unsigned char bits = 0;
  for (int k = 0; k < 3; ++k)
    bits |= (pick1[k] ? 1u : 0u) << k | (pick2[k] ? 1u : 0u) << (3 + k);
  m.e[j] = e;
  m.picks[j] = bits;
}

// Phase 1, once per step s < n_steps and chunk of C of the K directions
// (from direction `first` on; C = K: all of them at once): step s's t as a
// Dual<S, C>, its tangents stored among the K and its value by the first
// chunk. A later chunk computes the value again: layer_T over a wide dual
// holds too many registers (see MultiShape).
template <typename S, int K, int C>
OSC_HD void tile_phase1(const Tile& tile, int s, int first,
                        const int* step_point, const S* rho, const S* dx,
                        const TileMem<S>& m) {
  using T = typename PackOf<S, C>::type::type;
  const auto p = PackOf<S, C>::over(m.pack, m.pack + kPack * (1 + first));
  const int g = tile.first_step + s;
  const int j = step_point[g];
  const S e = m.e[j];
  bool pick1[3], pick2[3];
  for (int k = 0; k < 3; ++k) {
    pick1[k] = (m.picks[j] >> k) & 1u;
    pick2[k] = (m.picks[j] >> (3 + k)) & 1u;
  }
  Cx<T> t[3][3];
  layer_T(p, pick1, pick2, S(0.5) / e, S(2.0) * e, -(S(1.0) / e) * S(kHbarC),
          rho[g], dx[g], t);
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) {
      S* dst = m.t + (2 * (3 * i + k) * (1 + K)) * m.steps + s;
      put_parts(dst, m.steps, t[i][k].re, first, K);
      put_parts(dst + (1 + K) * m.steps, m.steps, t[i][k].im, first, K);
    }
}

template <typename S>
OSC_HD void put_result(S* out, S* dout, size_t at, size_t n6, S x, int first,
                       int k_all) {
  out[at] = x;
}
template <typename S, int C>
OSC_HD void put_result(S* out, S* dout, size_t at, size_t n6,
                       const Dual<S, C>& x, int first, int k_all) {
  if (first == 0 && out != nullptr) out[at] = x.v;
  for (int d = 0; d < C; ++d)
    if (first + d < k_all) dout[(first + d) * n6 + at] = x.d[d];
}

// Phase 2, once per q < 2 n_points and chunk of C of the K directions: point
// q / 2 from initial flavour a = q % 2 through its steps' t in order,
// v <- t v with the chunk's tangents (dv <- dt v + t dv, as dual
// arithmetic), then out[3a + b][i] (by the first chunk) and dout for the
// point's sorted index i, as chain_point computes them.
template <typename S, int K, int C>
OSC_HD void tile_phase2(const Tile& tile, int q, int first,
                        const int* point_step, const TileMem<S>& m, S* out,
                        S* dout, int n) {
  using T = typename PackOf<S, C>::type::type;
  const auto p = PackOf<S, C>::over(m.pack, m.pack + kPack * (1 + first));
  const int i = tile.first_point + q / 2;
  const int a = q % 2;
  Cx<T> v[3];
  initial_state(p, a, v);
  const int end = point_step[i + 1] - tile.first_step;
  for (int s = point_step[i] - tile.first_step; s < end; ++s) {
    Cx<T> t[3][3];
    for (int r = 0; r < 3; ++r)
      for (int k = 0; k < 3; ++k) {
        const S* src = m.t + (2 * (3 * r + k) * (1 + K)) * m.steps + s;
        get_parts(src, m.steps, &t[r][k].re, first, K);
        get_parts(src + (1 + K) * m.steps, m.steps, &t[r][k].im, first, K);
      }
    apply_T(t, v);
  }
  T res[3];
  flavour_probs(p, v, res);
  for (int b = 0; b < 3; ++b)
    put_result(out, dout, static_cast<size_t>(3 * a + b) * n + i,
               static_cast<size_t>(6) * n, res[b], first, K);
}

// -- the multitangent's shape -------------------------------------------------
// The directions that chunks of c reach when they cover k of them.
OSC_HD constexpr int padded(int k, int c) { return (k + c - 1) / c * c; }

// Per K: c1 directions per phase-1 thread, c2 per phase-2 thread, and the
// block's threads, from the card's measurements
// (scripts/tune_chain_multitangent.py; PERF.md has the figures). Phase 1
// holds at most 3 directions a thread, in the fewest equal chunks: a wider
// dual takes the fp64 instances past 255 registers, a narrower one computes
// the primal part more often. Phase 2 holds one: its threads are short, and
// more of them hide the chain walk's latency. A thread per step and chunk
// (tiles of kTileSteps steps). OSC_MT_C1, OSC_MT_C2 and OSC_MT_THREADS
// override them for every instance (the tuning script's builds).
template <typename S, int K>
struct MultiShape {
#ifdef OSC_MT_C1
  static constexpr int c1 = OSC_MT_C1 < K ? OSC_MT_C1 : K;
#else
  static constexpr int c1 = padded(K, (K + 2) / 3) / ((K + 2) / 3);
#endif
#ifdef OSC_MT_C2
  static constexpr int c2 = OSC_MT_C2 < K ? OSC_MT_C2 : K;
#else
  static constexpr int c2 = 1;
#endif
#ifdef OSC_MT_THREADS
  static constexpr int threads = OSC_MT_THREADS;
#else
  static constexpr int threads = kTileSteps * (padded(K, c1) / c1);
#endif
  // directions held by the pack in shared memory, zero past K
  static constexpr int k_pack =
      padded(K, c1) > padded(K, c2) ? padded(K, c1) : padded(K, c2);
  static constexpr size_t shared_bytes(int tile_steps) {
    return sizeof(S) * (static_cast<size_t>(tile_steps) * 18 * (1 + K) +
                        kPack * (1 + k_pack) + kTilePoints) +
           kTilePoints;
  }
};

#ifdef __CUDACC__
#if defined(OSC_CHAIN_PRIMAL) || defined(OSC_CHAIN_TANGENT)
// One block per (tile, lane); K = 0: the primal into `out`; K = 1: the
// tangent along `dpvec` into `dout` (no primal output). pvec, dpvec, out
// and dout hold one slice per lane (lane_slices).
template <typename S, int K>
__global__ void __launch_bounds__(kTileThreads)
    tile_kernel(const S* __restrict__ pvec, const S* __restrict__ dpvec,
                const int* __restrict__ tiles,
                const int* __restrict__ point_step,
                const int* __restrict__ step_point,
                const S* __restrict__ rho, const S* __restrict__ dx,
                const S* __restrict__ energy, S* __restrict__ out,
                S* __restrict__ dout, int n) {
  __shared__ TileShared<S, K> sh;
  const LaneSlices<S> lane =
      lane_slices(pvec, dpvec, out, dout, K, n, static_cast<int>(blockIdx.y));
  for (int k = threadIdx.x; k < kPack * (1 + K); k += blockDim.x)
    sh.pack[k] = k < kPack ? lane.pack[k] : lane.dirs[k - kPack];
  const TileMem<S> m = sh.mem();
  const Tile tile = tile_at(tiles, blockIdx.x);
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < tile.n_points) tile_phase0(tile, tid, energy, m);
  __syncthreads();
  if (tid < tile.n_steps)
    tile_phase1<S, K, K>(tile, tid, 0, step_point, rho, dx, m);
  __syncthreads();
  if (tid < 2 * tile.n_points)
    tile_phase2<S, K, K>(tile, tid, 0, point_step, m, lane.out, lane.dout,
                         n);
}

template <typename S, int K>
int launch_tiles(const S* pvec, const S* dpvec, const int* tiles,
                 const int* point_step, const int* step_point, const S* rho,
                 const S* dx, const S* energy, S* out, S* dout, int n_tiles,
                 int n, int lanes, void* stream) {
  if (lanes < 1 || lanes > kMaxLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles <= 0) return 0;
  tile_kernel<S, K><<<dim3(n_tiles, lanes), kTileThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      pvec, dpvec, tiles, point_step, step_point, rho, dx, energy, out, dout,
      n);
  return static_cast<int>(cudaGetLastError());
}
#endif

// A kernel's resources at `shared` bytes of dynamic shared memory: info =
// {registers per thread, local (spill) bytes per thread, shared bytes per
// block (static and dynamic), threads per block, resident blocks per SM};
// returns the first CUDA error.
template <typename F>
int kernel_attributes(F* kernel, int threads, size_t shared, int* info) {
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                     shared);
  info[0] = a.numRegs;
  info[1] = static_cast<int>(a.localSizeBytes);
  info[2] = static_cast<int>(a.sharedSizeBytes + shared);
  info[3] = threads;
  info[4] = blocks;
  return static_cast<int>(rc);
}

#ifdef OSC_CHAIN_MULTITANGENT
// The most dynamic shared memory a block may ask for on sm_90
constexpr size_t kMaxDynamicShared = 232448;

// One block per (tile of at most tile_steps steps, lane): the primal into
// `out` (unless it is null) and the K tangents along dpvecs (K, 57) into
// dout (K, 2, 3, N), each a slice per lane (lane_slices). Each phase is a
// loop of the block's threads over its work: points; (step, chunk of C1
// directions); (point, initial flavour, chunk of C2 directions), a chunk's
// threads being neighbours so that a warp's shared-memory accesses stay
// consecutive (phase 1) or pairwise equal (phase 2).
template <typename S, int K>
__global__ void __launch_bounds__(MultiShape<S, K>::threads)
    tile_multi_kernel(const S* __restrict__ pvec,
                      const S* __restrict__ dpvecs,
                      const int* __restrict__ tiles,
                      const int* __restrict__ point_step,
                      const int* __restrict__ step_point,
                      const S* __restrict__ rho, const S* __restrict__ dx,
                      const S* __restrict__ energy, S* __restrict__ out,
                      S* __restrict__ dout, int n, int tile_steps) {
  using Shape = MultiShape<S, K>;
  constexpr int c1 = Shape::c1, c2 = Shape::c2;
  extern __shared__ __align__(16) unsigned char tile_memory[];
  TileMem<S> m;
  m.t = reinterpret_cast<S*>(tile_memory);
  m.pack = m.t + static_cast<size_t>(tile_steps) * 18 * (1 + K);
  m.e = m.pack + kPack * (1 + Shape::k_pack);
  m.picks = reinterpret_cast<unsigned char*>(m.e + kTilePoints);
  m.steps = tile_steps;
  const LaneSlices<S> lane = lane_slices(pvec, dpvecs, out, dout, K, n,
                                         static_cast<int>(blockIdx.y));
  const int tid = threadIdx.x;
  for (int k = tid; k < kPack * (1 + Shape::k_pack); k += Shape::threads)
    m.pack[k] = k < kPack ? lane.pack[k]
                          : (k < kPack * (1 + K) ? lane.dirs[k - kPack]
                                                 : S(0));
  const Tile tile = tile_at(tiles, blockIdx.x);
  constexpr int chunks1 = padded(K, c1) / c1, chunks2 = padded(K, c2) / c2;
  __syncthreads();
  for (int j = tid; j < tile.n_points; j += Shape::threads)
    tile_phase0(tile, j, energy, m);
  __syncthreads();
  for (int w = tid; w < tile.n_steps * chunks1; w += Shape::threads)
    tile_phase1<S, K, c1>(tile, w % tile.n_steps, w / tile.n_steps * c1,
                          step_point, rho, dx, m);
  __syncthreads();
  const int walks = 2 * tile.n_points;
  for (int w = tid; w < walks * chunks2; w += Shape::threads)
    tile_phase2<S, K, c2>(tile, w % walks, w / walks * c2, point_step, m,
                          lane.out, lane.dout, n);
}

// In an unnamed namespace: the static of allow_shared is this library's own
// (as a template's static it would be one for the whole process, shared
// with any other build of this source loaded beside it).
namespace {
template <typename S, int K>
struct Multi {
  // above 48 KB a block's shared memory has to be allowed, once a kernel
  static cudaError_t allow_shared() {
    static const cudaError_t rc = cudaFuncSetAttribute(
        tile_multi_kernel<S, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxDynamicShared));
    return rc;
  }
  static int launch(const S* pvec, const S* dpvecs, const int* tiles,
                    const int* point_step, const int* step_point,
                    const S* rho, const S* dx, const S* energy, S* out,
                    S* dout, int n_tiles, int n, int tile_steps, int lanes,
                    void* stream) {
    using Shape = MultiShape<S, K>;
    if (lanes < 1 || lanes > kMaxLanes)
      return static_cast<int>(cudaErrorInvalidValue);
    if (n_tiles <= 0) return 0;
    if (tile_steps < 1 || Shape::shared_bytes(tile_steps) > kMaxDynamicShared)
      return static_cast<int>(cudaErrorInvalidValue);
    if (allow_shared() != cudaSuccess) return static_cast<int>(allow_shared());
    tile_multi_kernel<S, K><<<dim3(n_tiles, lanes), Shape::threads,
                              Shape::shared_bytes(tile_steps),
                              static_cast<cudaStream_t>(stream)>>>(
        pvec, dpvecs, tiles, point_step, step_point, rho, dx, energy, out,
        dout, n, tile_steps);
    return static_cast<int>(cudaGetLastError());
  }
  // info[5], info[6]: the shape's c1 and c2
  static int attributes(int tile_steps, int* info) {
    using Shape = MultiShape<S, K>;
    info[5] = Shape::c1;
    info[6] = Shape::c2;
    if (tile_steps < 1 || Shape::shared_bytes(tile_steps) > kMaxDynamicShared)
      return static_cast<int>(cudaErrorInvalidValue);
    if (allow_shared() != cudaSuccess) return static_cast<int>(allow_shared());
    return kernel_attributes(tile_multi_kernel<S, K>, Shape::threads,
                             Shape::shared_bytes(tile_steps), info);
  }
};
}  // namespace

// f(Multi<S, K>{}) for the runtime k in 1..kMaxTangents
template <typename S, typename F>
int with_multi(int k, F f) {
  switch (k) {
    case 1: return f(Multi<S, 1>{});
    case 2: return f(Multi<S, 2>{});
    case 3: return f(Multi<S, 3>{});
    case 4: return f(Multi<S, 4>{});
    case 5: return f(Multi<S, 5>{});
    case 6: return f(Multi<S, 6>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename S>
int launch_multi(const S* pvec, const S* dpvecs, int k, const int* tiles,
                 const int* point_step, const int* step_point, const S* rho,
                 const S* dx, const S* energy, S* out, S* dout, int n_tiles,
                 int n, int tile_steps, int lanes, void* stream) {
  return with_multi<S>(k, [&](auto multi) {
    return multi.launch(pvec, dpvecs, tiles, point_step, step_point, rho, dx,
                        energy, out, dout, n_tiles, n, tile_steps, lanes,
                        stream);
  });
}

template <typename S>
int multi_attributes(int k, int tile_steps, int* info) {
  return with_multi<S>(
      k, [&](auto multi) { return multi.attributes(tile_steps, info); });
}
#endif  // OSC_CHAIN_MULTITANGENT
#endif  // __CUDACC__

}  // namespace osc_chain

#ifdef __CUDACC__
// All pointers are device pointers, launched on `stream`, over `lanes`
// lanes (1..kMaxLanes, else cudaErrorInvalidValue): pvec (lanes, 57),
// dpvec (lanes, 57), dpvecs (lanes, K, 57); the tile table of
// ops/osc/chain.py:tile_table (tiles (n_tiles, 4) int32, point_step (N + 1,)
// int32, step_point, rho and dx (steps,)), cut to kTileSteps steps a tile
// for the primal and the tangent and to tile_steps for the multitangent,
// and energy (N,), all shared by the lanes; out (lanes, 2, 3, N), dout
// (lanes, 2, 3, N) or (lanes, K, 2, 3, N). Each launch returns the
// cudaError_t of its launch (0 on success); each *_attributes fills info
// (7 ints) as osc_chain::kernel_attributes and Multi::attributes do (k and
// tile_steps: the multitangent's, ignored by the others).
#ifdef OSC_CHAIN_PRIMAL
extern "C" int osc_chain_f32(const float* pvec, const int* tiles,
                             const int* point_step, const int* step_point,
                             const float* rho, const float* dx,
                             const float* energy, float* out, int n_tiles,
                             int n, int lanes, void* stream) {
  return osc_chain::launch_tiles<float, 0>(pvec, nullptr, tiles, point_step,
                                           step_point, rho, dx, energy, out,
                                           nullptr, n_tiles, n, lanes, stream);
}

extern "C" int osc_chain_f64(const double* pvec, const int* tiles,
                             const int* point_step, const int* step_point,
                             const double* rho, const double* dx,
                             const double* energy, double* out, int n_tiles,
                             int n, int lanes, void* stream) {
  return osc_chain::launch_tiles<double, 0>(pvec, nullptr, tiles, point_step,
                                            step_point, rho, dx, energy, out,
                                            nullptr, n_tiles, n, lanes,
                                            stream);
}

extern "C" int osc_chain_attributes_f32(int k, int tile_steps, int* info) {
  return osc_chain::kernel_attributes(osc_chain::tile_kernel<float, 0>,
                                      osc_chain::kTileThreads, 0, info);
}

extern "C" int osc_chain_attributes_f64(int k, int tile_steps, int* info) {
  return osc_chain::kernel_attributes(osc_chain::tile_kernel<double, 0>,
                                      osc_chain::kTileThreads, 0, info);
}
#endif  // OSC_CHAIN_PRIMAL

#ifdef OSC_CHAIN_TANGENT
extern "C" int osc_chain_tangent_f32(const float* pvec, const float* dpvec,
                                     const int* tiles, const int* point_step,
                                     const int* step_point, const float* rho,
                                     const float* dx, const float* energy,
                                     float* dout, int n_tiles, int n,
                                     int lanes, void* stream) {
  return osc_chain::launch_tiles<float, 1>(pvec, dpvec, tiles, point_step,
                                           step_point, rho, dx, energy,
                                           nullptr, dout, n_tiles, n, lanes,
                                           stream);
}

extern "C" int osc_chain_tangent_f64(const double* pvec, const double* dpvec,
                                     const int* tiles, const int* point_step,
                                     const int* step_point, const double* rho,
                                     const double* dx, const double* energy,
                                     double* dout, int n_tiles, int n,
                                     int lanes, void* stream) {
  return osc_chain::launch_tiles<double, 1>(pvec, dpvec, tiles, point_step,
                                            step_point, rho, dx, energy,
                                            nullptr, dout, n_tiles, n, lanes,
                                            stream);
}

extern "C" int osc_chain_tangent_attributes_f32(int k, int tile_steps,
                                                int* info) {
  return osc_chain::kernel_attributes(osc_chain::tile_kernel<float, 1>,
                                      osc_chain::kTileThreads, 0, info);
}

extern "C" int osc_chain_tangent_attributes_f64(int k, int tile_steps,
                                                int* info) {
  return osc_chain::kernel_attributes(osc_chain::tile_kernel<double, 1>,
                                      osc_chain::kTileThreads, 0, info);
}
#endif  // OSC_CHAIN_TANGENT

#ifdef OSC_CHAIN_MULTITANGENT
extern "C" int osc_chain_multitangent_f32(
    const float* pvec, const float* dpvecs, int k, const int* tiles,
    const int* point_step, const int* step_point, const float* rho,
    const float* dx, const float* energy, float* out, float* dout,
    int n_tiles, int n, int tile_steps, int lanes, void* stream) {
  return osc_chain::launch_multi<float>(pvec, dpvecs, k, tiles, point_step,
                                        step_point, rho, dx, energy, out, dout,
                                        n_tiles, n, tile_steps, lanes, stream);
}

extern "C" int osc_chain_multitangent_f64(
    const double* pvec, const double* dpvecs, int k, const int* tiles,
    const int* point_step, const int* step_point, const double* rho,
    const double* dx, const double* energy, double* out, double* dout,
    int n_tiles, int n, int tile_steps, int lanes, void* stream) {
  return osc_chain::launch_multi<double>(pvec, dpvecs, k, tiles, point_step,
                                         step_point, rho, dx, energy, out,
                                         dout, n_tiles, n, tile_steps, lanes,
                                         stream);
}

extern "C" int osc_chain_multitangent_attributes_f32(int k, int tile_steps,
                                                     int* info) {
  return osc_chain::multi_attributes<float>(k, tile_steps, info);
}

extern "C" int osc_chain_multitangent_attributes_f64(int k, int tile_steps,
                                                     int* info) {
  return osc_chain::multi_attributes<double>(k, tile_steps, info);
}
#endif  // OSC_CHAIN_MULTITANGENT
#endif  // __CUDACC__
