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
//   plus K tangents, each layer step linearized once) -> dual_kernel<S, K>.
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
// The primal and tangent kernels (tile_kernel): layer-parallel tiles.
// A layer step's T depends on the pack, the point's energy and the layer's
// (rho, dx), never on the state, so the chain dependence is only the cheap
// v <- T v. One thread per point, as before, ran each chain serially: the
// kernel took as long as its longest chains (24 steps of ~470 / ~1,430
// dependent operations), while most threads finished after ~7 steps, and
// the 157 blocks left the card nearly empty (the fp32 tangent, at 168
// registers, ran 1 block per SM in two waves). The tile design:
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
// The multitangent (dual_kernel<S, K>) keeps one thread per point: it runs
// chain_point, the whole chain in registers, over Dual<S, K>. Its registers
// grow with K (the fp64 K >= 3 instances spill); it is off on the main path.
// chain_point also serves the host tests of the arithmetic
// (tests/test_torch_chain_source.py), which hold the tile pass against it.
//
// Both designs read the pack and its tangent directions from device
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
static_assert(kMaxTangents == 6, "launch_multi dispatches K = 1..6");
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

// A scalar's components in memory: the value, then its K tangents, each
// `stride` apart (tile_kernel's shared-memory T and its outputs).
template <typename T>
struct Parts {
  static constexpr int n = 1;
};
template <typename S, int K>
struct Parts<Dual<S, K>> {
  static constexpr int n = 1 + K;
};
template <typename S>
OSC_HD void put_parts(S* dst, int stride, S x) { dst[0] = x; }
template <typename S, int K>
OSC_HD void put_parts(S* dst, int stride, const Dual<S, K>& x) {
  dst[0] = x.v;
  for (int k = 0; k < K; ++k) dst[(1 + k) * stride] = x.d[k];
}
template <typename S>
OSC_HD void get_parts(const S* src, int stride, S* x) { *x = src[0]; }
template <typename S, int K>
OSC_HD void get_parts(const S* src, int stride, Dual<S, K>* x) {
  x->v = src[0];
  for (int k = 0; k < K; ++k) x->d[k] = src[(1 + k) * stride];
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
// The pack type of a pass with K tangents (0: the primal) over the pack and
// its directions, stored back to back.
template <typename S, int K>
struct PackOf {
  using type = DualPack<S, K>;
  static OSC_HD type over(const S* p) { return type{p, p + kPack}; }
};
template <typename S>
struct PackOf<S, 0> {
  using type = PlainPack<S>;
  static OSC_HD type over(const S* p) { return type{p}; }
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

// One point's full chain, serially (the multitangent kernel and the host
// tests). `p` reads the pack (T = P::type: plain or dual); `e` and the
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

// -- the layer-parallel tile pass (tile_kernel), one function per phase ------
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

// scalars of one step's t in shared memory: 9 complex entries x Parts
template <typename T>
constexpr int kStepScalars = 18 * Parts<T>::n;

// Shared memory of one tile block: the pack (and its K directions), each
// point's energy and packed vacuum picks, and the tile's steps' t,
// structure-of-arrays: component c of step s at t[c * kTileSteps + s].
template <typename S, int K>
struct TileShared {
  using T = typename PackOf<S, K>::type::type;
  S pack[kPack * (1 + K)];
  S e[kTilePoints];
  unsigned char picks[kTilePoints];
  S t[kTileSteps * kStepScalars<T>];
};

// Phase 0, thread j < n_points: point j's energy and vacuum picks (bits
// 0-2: pick1, bits 3-5: pick2), from the pack's values.
template <typename S, int K>
OSC_HD void tile_phase0(const Tile& tile, int j, const S* energy,
                        TileShared<S, K>* sh) {
  const auto p = PackOf<S, K>::over(sh->pack);
  const S e = energy[tile.first_point + j];
  bool pick1[3], pick2[3];
  vacuum_picks(value(p(54)), value(p(55)), value(p(56)), S(0.5) / e,
               S(2.0) * e, pick1, pick2);
  unsigned char bits = 0;
  for (int k = 0; k < 3; ++k)
    bits |= (pick1[k] ? 1u : 0u) << k | (pick2[k] ? 1u : 0u) << (3 + k);
  sh->e[j] = e;
  sh->picks[j] = bits;
}

// Phase 1, thread s < n_steps: step s's t (a dual t for K > 0).
template <typename S, int K>
OSC_HD void tile_phase1(const Tile& tile, int s, const int* step_point,
                        const S* rho, const S* dx, TileShared<S, K>* sh) {
  using T = typename TileShared<S, K>::T;
  const auto p = PackOf<S, K>::over(sh->pack);
  const int g = tile.first_step + s;
  const int j = step_point[g];
  const S e = sh->e[j];
  bool pick1[3], pick2[3];
  for (int k = 0; k < 3; ++k) {
    pick1[k] = (sh->picks[j] >> k) & 1u;
    pick2[k] = (sh->picks[j] >> (3 + k)) & 1u;
  }
  Cx<T> t[3][3];
  layer_T(p, pick1, pick2, S(0.5) / e, S(2.0) * e, -(S(1.0) / e) * S(kHbarC),
          rho[g], dx[g], t);
  constexpr int parts = Parts<T>::n;
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) {
      S* dst = sh->t + (2 * (3 * i + k) * parts) * kTileSteps + s;
      put_parts(dst, kTileSteps, t[i][k].re);
      put_parts(dst + parts * kTileSteps, kTileSteps, t[i][k].im);
    }
}

template <typename S>
OSC_HD void put_result(S* out, S* dout, size_t at, size_t n6, S x) {
  out[at] = x;
}
template <typename S, int K>
OSC_HD void put_result(S* out, S* dout, size_t at, size_t n6,
                       const Dual<S, K>& x) {
  if (out != nullptr) out[at] = x.v;
  for (int j = 0; j < K; ++j) dout[j * n6 + at] = x.d[j];
}

// Phase 2, thread q < 2 n_points: point q / 2 from initial flavour a = q % 2
// through its steps' t in order, then out[3a + b][i] (and dout) for the
// point's sorted index i, as chain_point computes them.
template <typename S, int K>
OSC_HD void tile_phase2(const Tile& tile, int q, const int* point_step,
                        const TileShared<S, K>* sh, S* out, S* dout,
                        int n) {
  using T = typename TileShared<S, K>::T;
  const auto p = PackOf<S, K>::over(sh->pack);
  const int i = tile.first_point + q / 2;
  const int a = q % 2;
  Cx<T> v[3];
  initial_state(p, a, v);
  constexpr int parts = Parts<T>::n;
  const int end = point_step[i + 1] - tile.first_step;
  for (int s = point_step[i] - tile.first_step; s < end; ++s) {
    Cx<T> t[3][3];
    for (int r = 0; r < 3; ++r)
      for (int k = 0; k < 3; ++k) {
        const S* src = sh->t + (2 * (3 * r + k) * parts) * kTileSteps + s;
        get_parts(src, kTileSteps, &t[r][k].re);
        get_parts(src + parts * kTileSteps, kTileSteps, &t[r][k].im);
      }
    apply_T(t, v);
  }
  T res[3];
  flavour_probs(p, v, res);
  for (int b = 0; b < 3; ++b)
    put_result(out, dout, static_cast<size_t>(3 * a + b) * n + i,
               static_cast<size_t>(6) * n, res[b]);
}

#ifdef __CUDACC__
#if defined(OSC_CHAIN_PRIMAL) || defined(OSC_CHAIN_TANGENT)
// One block per tile; K = 0: the primal into `out`; K = 1: the tangent along
// `dpvec` into `dout` (no primal output).
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
  for (int k = threadIdx.x; k < kPack * (1 + K); k += blockDim.x)
    sh.pack[k] = k < kPack ? pvec[k] : dpvec[k - kPack];
  const Tile tile = tile_at(tiles, blockIdx.x);
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < tile.n_points) tile_phase0(tile, tid, energy, &sh);
  __syncthreads();
  if (tid < tile.n_steps) tile_phase1(tile, tid, step_point, rho, dx, &sh);
  __syncthreads();
  if (tid < 2 * tile.n_points)
    tile_phase2(tile, tid, point_step, &sh, out, dout, n);
}

template <typename S, int K>
int launch_tiles(const S* pvec, const S* dpvec, const int* tiles,
                 const int* point_step, const int* step_point, const S* rho,
                 const S* dx, const S* energy, S* out, S* dout, int n_tiles,
                 int n, void* stream) {
  if (n_tiles <= 0) return 0;
  tile_kernel<S, K><<<n_tiles, kTileThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      pvec, dpvec, tiles, point_step, step_point, rho, dx, energy, out, dout,
      n);
  return static_cast<int>(cudaGetLastError());
}
#endif

#ifdef OSC_CHAIN_MULTITANGENT
constexpr int kThreads = 256;

// The primal (written to `out` unless it is null) and K tangents along the
// directions dpvecs (K, 57), written to dout (K, 2, 3, N); one thread per
// point.
template <typename S, int K>
__global__ void dual_kernel(const S* __restrict__ pvec,
                            const S* __restrict__ dpvecs,
                            const int* __restrict__ nl,
                            const S* __restrict__ energy,
                            const S* __restrict__ dens,
                            const S* __restrict__ dist, S* __restrict__ out,
                            S* __restrict__ dout, int n) {
  __shared__ S p[kPack * (1 + K)];
  for (int k = threadIdx.x; k < kPack * (1 + K); k += blockDim.x)
    p[k] = k < kPack ? pvec[k] : dpvecs[k - kPack];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Dual<S, K> res[6];
  chain_point(DualPack<S, K>{p, p + kPack}, nl[i], energy[i], dens + i,
              dist + i, static_cast<size_t>(n), res);
  if (out != nullptr)
    for (int k = 0; k < 6; ++k) out[static_cast<size_t>(k) * n + i] = res[k].v;
  for (int j = 0; j < K; ++j)
    for (int k = 0; k < 6; ++k)
      dout[static_cast<size_t>(6 * j + k) * n + i] = res[k].d[j];
}

template <typename S, int K>
int launch_dual(const S* pvec, const S* dpvecs, const int* nl,
                const S* energy, const S* dens, const S* dist, S* out,
                S* dout, int n, void* stream) {
  if (n <= 0) return 0;
  dual_kernel<S, K><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      pvec, dpvecs, nl, energy, dens, dist, out, dout, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_multi(const S* pvec, const S* dpvecs, int k, const int* nl,
                 const S* energy, const S* dens, const S* dist, S* out,
                 S* dout, int n, void* stream) {
  switch (k) {
    case 1: return launch_dual<S, 1>(pvec, dpvecs, nl, energy, dens, dist, out, dout, n, stream);
    case 2: return launch_dual<S, 2>(pvec, dpvecs, nl, energy, dens, dist, out, dout, n, stream);
    case 3: return launch_dual<S, 3>(pvec, dpvecs, nl, energy, dens, dist, out, dout, n, stream);
    case 4: return launch_dual<S, 4>(pvec, dpvecs, nl, energy, dens, dist, out, dout, n, stream);
    case 5: return launch_dual<S, 5>(pvec, dpvecs, nl, energy, dens, dist, out, dout, n, stream);
    case 6: return launch_dual<S, 6>(pvec, dpvecs, nl, energy, dens, dist, out, dout, n, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif  // OSC_CHAIN_MULTITANGENT

// A kernel's resources: info = {registers per thread, local (spill) bytes
// per thread, static shared bytes per block, threads per block, resident
// blocks per SM}; returns the first CUDA error.
template <typename F>
int kernel_attributes(F* kernel, int threads, int* info) {
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                     0);
  info[0] = a.numRegs;
  info[1] = static_cast<int>(a.localSizeBytes);
  info[2] = static_cast<int>(a.sharedSizeBytes);
  info[3] = threads;
  info[4] = blocks;
  return static_cast<int>(rc);
}

#ifdef OSC_CHAIN_MULTITANGENT
template <typename S>
int multi_attributes(int k, int* info) {
  switch (k) {
    case 1: return kernel_attributes(dual_kernel<S, 1>, kThreads, info);
    case 2: return kernel_attributes(dual_kernel<S, 2>, kThreads, info);
    case 3: return kernel_attributes(dual_kernel<S, 3>, kThreads, info);
    case 4: return kernel_attributes(dual_kernel<S, 4>, kThreads, info);
    case 5: return kernel_attributes(dual_kernel<S, 5>, kThreads, info);
    case 6: return kernel_attributes(dual_kernel<S, 6>, kThreads, info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif  // OSC_CHAIN_MULTITANGENT
#endif  // __CUDACC__

}  // namespace osc_chain

#ifdef __CUDACC__
// All pointers are device pointers, launched on `stream`: pvec (57,),
// dpvec (57,), dpvecs (K, 57); the tile table of ops/osc/chain.py:tile_table
// (tiles (n_tiles, 4) int32, point_step (N + 1,) int32, step_point,
// rho and dx (steps,)); nl (N,) int32, energy (N,), dens/dist (L, N)
// layer-major; out (2, 3, N), dout (2, 3, N) or (K, 2, 3, N). Each launch
// returns the cudaError_t of its launch (0 on success); each *_attributes
// fills info as osc_chain::kernel_attributes does (k: the multitangent's K,
// ignored by the others).
#ifdef OSC_CHAIN_PRIMAL
extern "C" int osc_chain_f32(const float* pvec, const int* tiles,
                             const int* point_step, const int* step_point,
                             const float* rho, const float* dx,
                             const float* energy, float* out, int n_tiles,
                             int n, void* stream) {
  return osc_chain::launch_tiles<float, 0>(pvec, nullptr, tiles, point_step,
                                           step_point, rho, dx, energy, out,
                                           nullptr, n_tiles, n, stream);
}

extern "C" int osc_chain_f64(const double* pvec, const int* tiles,
                             const int* point_step, const int* step_point,
                             const double* rho, const double* dx,
                             const double* energy, double* out, int n_tiles,
                             int n, void* stream) {
  return osc_chain::launch_tiles<double, 0>(pvec, nullptr, tiles, point_step,
                                            step_point, rho, dx, energy, out,
                                            nullptr, n_tiles, n, stream);
}

extern "C" int osc_chain_attributes_f32(int k, int* info) {
  return osc_chain::kernel_attributes(osc_chain::tile_kernel<float, 0>,
                                      osc_chain::kTileThreads, info);
}

extern "C" int osc_chain_attributes_f64(int k, int* info) {
  return osc_chain::kernel_attributes(osc_chain::tile_kernel<double, 0>,
                                      osc_chain::kTileThreads, info);
}
#endif  // OSC_CHAIN_PRIMAL

#ifdef OSC_CHAIN_TANGENT
extern "C" int osc_chain_tangent_f32(const float* pvec, const float* dpvec,
                                     const int* tiles, const int* point_step,
                                     const int* step_point, const float* rho,
                                     const float* dx, const float* energy,
                                     float* dout, int n_tiles, int n,
                                     void* stream) {
  return osc_chain::launch_tiles<float, 1>(pvec, dpvec, tiles, point_step,
                                           step_point, rho, dx, energy,
                                           nullptr, dout, n_tiles, n, stream);
}

extern "C" int osc_chain_tangent_f64(const double* pvec, const double* dpvec,
                                     const int* tiles, const int* point_step,
                                     const int* step_point, const double* rho,
                                     const double* dx, const double* energy,
                                     double* dout, int n_tiles, int n,
                                     void* stream) {
  return osc_chain::launch_tiles<double, 1>(pvec, dpvec, tiles, point_step,
                                            step_point, rho, dx, energy,
                                            nullptr, dout, n_tiles, n, stream);
}

extern "C" int osc_chain_tangent_attributes_f32(int k, int* info) {
  return osc_chain::kernel_attributes(osc_chain::tile_kernel<float, 1>,
                                      osc_chain::kTileThreads, info);
}

extern "C" int osc_chain_tangent_attributes_f64(int k, int* info) {
  return osc_chain::kernel_attributes(osc_chain::tile_kernel<double, 1>,
                                      osc_chain::kTileThreads, info);
}
#endif  // OSC_CHAIN_TANGENT

#ifdef OSC_CHAIN_MULTITANGENT
extern "C" int osc_chain_multitangent_f32(const float* pvec,
                                          const float* dpvecs, int k,
                                          const int* nl, const float* energy,
                                          const float* dens, const float* dist,
                                          float* out, float* dout, int n,
                                          void* stream) {
  return osc_chain::launch_multi<float>(pvec, dpvecs, k, nl, energy, dens,
                                        dist, out, dout, n, stream);
}

extern "C" int osc_chain_multitangent_f64(const double* pvec,
                                          const double* dpvecs, int k,
                                          const int* nl, const double* energy,
                                          const double* dens,
                                          const double* dist, double* out,
                                          double* dout, int n, void* stream) {
  return osc_chain::launch_multi<double>(pvec, dpvecs, k, nl, energy, dens,
                                         dist, out, dout, n, stream);
}

extern "C" int osc_chain_multitangent_attributes_f32(int k, int* info) {
  return osc_chain::multi_attributes<float>(k, info);
}

extern "C" int osc_chain_multitangent_attributes_f64(int k, int* info) {
  return osc_chain::multi_attributes<double>(k, info);
}
#endif  // OSC_CHAIN_MULTITANGENT
#endif  // __CUDACC__
