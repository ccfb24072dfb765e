// Weighted sums of Gaussian kernels for the adaptive KDE, their
// vector-Jacobian product and their Jacobian-vector product, for NVIDIA
// Hopper (sm_90a), float32 and float64.
//
// Not a port of a Pallas kernel. It replaces the XLA contraction of
// pisa_tpu/utils/kde.py:101-115 (density_at in adaptive_gaussian_kde), which
// the JAX package evaluates as one dense (N samples x M points) elementwise
// product and sum. The reference PISA ran the same sum on the card through
// an external CUDA package (kde.cudakde) for the same reason this kernel
// exists: the (N, M) intermediate (1.6 GB in float32 at N = M = 20,000, for
// each of 24 category x PID channels) never has to be in device memory.
//
// What it computes, for a batch b of B independent densities (a category's
// PID channel), D <= 3 dimensions, N samples x and M points p:
//
//   kde_gauss_sum:      out[b, j] = sum_i c[b,i] exp(-1/2 il2[b,i] z_ij)
//   kde_gauss_sum_vjp:  A[b, i]    = sum_j g[b,j] k_ij
//                       C[b, d, i] = sum_j g[b,j] k_ij u_dij^2
//   kde_gauss_sum_jvp:  out[b, j] as the sum, and its tangent
//                       dout[b, j] = sum_i k_ij (dc[b,i] - 1/2 c[b,i]
//                                    (dil2[b,i] z_ij + il2[b,i] dz_ij))
//
// with u_dij = p[d,j] ih[b,d] - x[b,d,i] ih[b,d] (the difference scaled by
// the inverse bandwidth ih), z_ij = sum_d u_dij^2, k_ij the exponential and
// il2 = 1 / lambda^2 the adaptive widths. pisa_tpu_torch/ops/kde.py forms
// the gradients of c, lambda and h from A and C with torch ops. The jvp
// takes the tangents dc, dil2 and dih of c, il2 and ih (x and the points
// are data); dz_ij = sum_d 2 ih_d dih_d (p_dj - x_di)^2 = sum_d 2 r_d
// u_dij^2 with r_d = dih_d / ih_d, which each thread forms once.
//
// Live counts. Each row b may give n_live[b] and m_live[b] (device memory,
// int32; a null pointer means all N or all M): the sums run over the first
// n_live[b] samples and the first m_live[b] points only, and the outputs
// past them are written as zeros. The stacked KDE stage evaluates every
// category's samples in every PID channel; utils/kde.py:KDEPlan orders each
// channel's own samples first (from the PID cut and the stacking's padding,
// never from the weights), so the pairs of a sample with another channel's
// samples, which the dense sum multiplied by a zero weight, are never
// visited. A row without a live sample does no pair work.
//
// What bounds them on the card: operations, not bytes. Each pair costs one
// exponential and 3D + 2 (sum), 5D + 2 (vjp) or 5D + 9 (jvp) floating-point
// operations, against (D + 2) (N + M) values read once. In float32 the
// exponential's MUFU.EX2 (16 a clock per SM, a quarter of a warp a clock
// per scheduler: 8 clocks a warp) is the slower pipe; in float64 the
// exponential is a polynomial on the FMA pipe (ops/kde.py:kde_operations
// counts both). The design of the sum and the vjp against that bound:
//
// - Register tiles. A thread owns R outputs (points for the sum, samples
//   for the vjp; R consecutive indices, so that the threads whose outputs
//   are all past the live count form whole idle warps). A block stages a
//   tile of kThreads entries of the other side in shared memory, packed as
//   one 16-byte load in float32 at D <= 2: (x_0 ih_0, x_1 ih_1, -1/2 il2
//   log2(e), c) for the sum, (p_0 ih_0, p_1 ih_1, g, 0) for the vjp. One
//   staged load serves R pairs.
// - Exponentials. In float32 log2(e) is folded into the staged width, so
//   the exponent is one multiply of z and the exponential one ex2.approx.ftz
//   on MUFU (relative error 2^-22, results below 2^-126 flushed to 0), with
//   no range reduction on the FMA pipe. A float32 pair of the sum at D = 2
//   is then 6 FMA-pipe instructions (2 subtractions, a multiply and a
//   multiply-add for z, the width's multiply, the weight's multiply-add)
//   beside its MUFU.EX2: 7 dispatch slots a warp against MUFU's 8 clocks, so
//   MUFU bounds it. The vjp's pair has D squares, z's sum, the width's
//   multiply, g k, the sum A and D multiply-adds for C: 10 FMA-pipe
//   instructions at D = 2, 11 dispatch slots against MUFU's 8, so dispatch
//   bounds it at about 8 / 11 of the bound. float64 keeps exp(), a
//   polynomial on the FMA pipe.
// - The vjp's guard. Where u^2 overflows (a channel whose bandwidth is
//   clamped to 1e-30, so ih = 1e30), k is 0 and g k u^2 would be 0 * inf.
//   A tile is guarded, with u^2 clamped at the type's largest finite value
//   before the multiply, only where a staged or an owned coordinate is over
//   half the square root of that value (one __syncthreads_or a tile, no
//   branch in the pair loop); elsewhere no u^2 can overflow and the loop
//   runs without the clamps. The sum needs no guard: its term is c k.
// - Filling 132 SMs. Where the outer side is short (the grid's 1,320
//   points), the inner side is cut over gridDim.z blocks ("splits", chosen
//   by the wrapper from the shapes alone): each writes its partial sums to
//   a (splits, ...) scratch, and a second pass adds them in a fixed order,
//   so the result is the same from run to run (no float atomics).
// - Tensor cores do not apply: the distance has depth D <= 3, the pair's
//   cost is the exponential and not a product, and the expanded form
//   |x|^2 + |p|^2 - 2 x.p in TF32 would lose the 1e-4 float32 bound to
//   cancellation.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py:kde_vs_plain,
// float32, kde_example's 24 channels of 20,000 samples, R = 4 and 128
// threads, the best of scripts/tune_kde.py's shapes): the pilot's sum at
// 81% of its bound dense (2.83 ms) and 74% on kde_example's live pairs
// (1.06 ms, 34% of the dense pairs); its vjp at 56% and 52% (4.09 and 1.52
// ms), near its dispatch bound; the grid's passes (1,320 points) at 67% / 59%
// (sum) and 53% / 45% (vjp), where the second pass and the launch weigh
// more. float64 is bounded by exp() on the FMA pipe at 10-17% of the
// bound that counts it as one operation.
//
// The jvp keeps its first design: one thread per point, five staged arrays,
// expf, a k != 0 branch in the pair loop; it takes the same live counts as
// loop bounds.
//
// A channel without weight (every c zero) has its bandwidth clamped to
// 1e-30 (utils/kde.py), so ih = 1e30 and u^2 overflows to inf: the sum then
// takes 0 * exp(-inf) = 0, the vjp guards as above, and the jvp skips such
// terms of its tangent sum (k z). Its adaptive widths lambda are huge (its
// pilot is 0), so il2 may underflow to 0 as well, and the exponent would be
// 0 * inf = NaN: every kernel floors il2 at the type's smallest normal
// number as it stages it (once a sample, not in the inner loop), so that
// such a term's k is exp(-inf) = 0. The floor changes no k whose il2 is
// normal.
//
// Built without fast-math (utils/cuda_build.py): the float32 exponential is
// asked for explicitly, everything else keeps IEEE arithmetic. The sum over
// N terms runs in the working type.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libkde_gauss.so kde_gauss.cu
// (-DKDE_SUM_R, -DKDE_SUM_THREADS, -DKDE_VJP_R and -DKDE_VJP_THREADS set
// the tiles for a whole build; scripts/tune_kde.py times the choices.)
// Bound through ctypes (pisa_tpu_torch/ops/kde.py); each launch entry point
// returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

#ifndef KDE_SUM_R
#define KDE_SUM_R 4
#endif
#ifndef KDE_SUM_THREADS
#define KDE_SUM_THREADS 128
#endif
#ifndef KDE_VJP_R
#define KDE_VJP_R 4
#endif
#ifndef KDE_VJP_THREADS
#define KDE_VJP_THREADS 128
#endif

namespace kde_gauss {

constexpr int kSumR = KDE_SUM_R;
constexpr int kSumThreads = KDE_SUM_THREADS;
constexpr int kVjpR = KDE_VJP_R;
constexpr int kVjpThreads = KDE_VJP_THREADS;
constexpr int kJvpThreads = 256;
constexpr int kReduceThreads = 256;

// the exponential of the sum and the vjp: ex2 on MUFU of an exponent that
// carries log2(e) in float32, exp in float64; kScale is the factor of il2
// in the staged width
template <typename S>
struct Exp;
template <>
struct Exp<float> {
  static constexpr float kScale = -0.72134752044448170f;  // -log2(e) / 2
  static __device__ __forceinline__ float of(float e) {
    float k;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(k) : "f"(e));
    return k;
  }
};
template <>
struct Exp<double> {
  static constexpr double kScale = -0.5;
  static __device__ __forceinline__ double of(double e) { return exp(e); }
};

// the jvp's exponential (its first design)
__device__ __forceinline__ float kexp(float x) { return expf(x); }
__device__ __forceinline__ double kexp(double x) { return exp(x); }

// tiny: the smallest normal number, the floor of the widths il2 (see
// above); huge: the largest finite value, where the vjp clamps u^2; safe:
// half the square root of huge, the largest coordinate for which no u^2
// can overflow
template <typename S>
struct Limits;
template <>
struct Limits<float> {
  static __device__ __forceinline__ float tiny() { return 1.17549435e-38f; }
  static __device__ __forceinline__ float huge() { return 3.40282347e38f; }
  static __device__ __forceinline__ float safe() { return 9.0e18f; }
};
template <>
struct Limits<double> {
  static __device__ __forceinline__ double tiny() {
    return 2.2250738585072014e-308;
  }
  static __device__ __forceinline__ double huge() {
    return 1.7976931348623157e308;
  }
  static __device__ __forceinline__ double safe() { return 6.0e153; }
};

__device__ __forceinline__ float minimum(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double minimum(double a, double b) {
  return fmin(a, b);
}

// one staged entry: V values padded to whole 16-byte words
template <typename S, int V>
struct alignas(16) Pack {
  static constexpr int kPerWord = 16 / sizeof(S);
  static constexpr int kW = (V + kPerWord - 1) / kPerWord * kPerWord;
  S v[kW];
};

// a row's live count: all of `full` without counts
__device__ __forceinline__ int live_count(const int* counts, int b,
                                          int full) {
  return counts ? max(0, min(counts[b], full)) : full;
}

// [lo, hi) of the live inner range that split blockIdx.z of gridDim.z
// takes: whole tiles of `tile` entries, the last split the rest
__device__ __forceinline__ void split_range(int live, int tile, int* lo,
                                            int* hi) {
  const int splits = gridDim.z;
  const int per = (live + splits - 1) / splits;
  const int chunk = (per + tile - 1) / tile * tile;
  *lo = min(live, static_cast<int>(blockIdx.z) * chunk);
  *hi = min(live, *lo + chunk);
}

// out[b, j] for the R points j of each thread of this block, over the
// samples of split blockIdx.z, into out + blockIdx.z * split_stride;
// p_bstride is 0 when every b shares the points, D * M when each has its
// own.
template <typename S, int D, int R, int T>
__global__ void __launch_bounds__(T)
    sum_kernel(const S* __restrict__ x, const S* __restrict__ p,
               long long p_bstride, const S* __restrict__ ih,
               const S* __restrict__ il2, const S* __restrict__ c,
               const int* __restrict__ n_live,
               const int* __restrict__ m_live, S* __restrict__ out,
               long long split_stride, int n, int m) {
  using E = Pack<S, D + 2>;
  __shared__ E tile[T];
  const int b = blockIdx.y;
  const int nb = live_count(n_live, b, n);
  const int mb = live_count(m_live, b, m);
  const int first = blockIdx.x * (T * R);
  const int j0 = first + threadIdx.x * R;
  S h[D], pj[R][D], acc[R];
  const S* pb = p + b * p_bstride;
#pragma unroll
  for (int d = 0; d < D; ++d) h[d] = ih[b * D + d];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + r;
#pragma unroll
    for (int d = 0; d < D; ++d)
      pj[r][d] = j < mb ? pb[static_cast<long long>(d) * m + j] * h[d] : S(0);
    acc[r] = S(0);
  }
  int lo, hi;
  split_range(nb, T, &lo, &hi);
  if (first < mb && lo < hi) {  // uniform over the block
    const bool active = j0 < mb;
    const S* xb = x + static_cast<long long>(b) * D * n;
    const S* lb = il2 + static_cast<long long>(b) * n;
    const S* cb = c + static_cast<long long>(b) * n;
    for (int i0 = lo; i0 < hi; i0 += T) {
      const int i = i0 + threadIdx.x;
      if (i < hi) {
        E e;
#pragma unroll
        for (int w = 0; w < E::kW; ++w) e.v[w] = S(0);
#pragma unroll
        for (int d = 0; d < D; ++d)
          e.v[d] = xb[static_cast<long long>(d) * n + i] * h[d];
        e.v[D] = Exp<S>::kScale * fmax(lb[i], Limits<S>::tiny());
        e.v[D + 1] = cb[i];
        tile[threadIdx.x] = e;
      }
      __syncthreads();
      if (active) {
        const int cnt = min(T, hi - i0);
#pragma unroll 4
        for (int t = 0; t < cnt; ++t) {
          const E e = tile[t];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const S u0 = pj[r][0] - e.v[0];
            S z = u0 * u0;
#pragma unroll
            for (int d = 1; d < D; ++d) {
              const S u = pj[r][d] - e.v[d];
              z = fma(u, u, z);
            }
            acc[r] = fma(e.v[D + 1], Exp<S>::of(e.v[D] * z), acc[r]);
          }
        }
      }
      __syncthreads();
    }
  }
  S* ob = out + blockIdx.z * split_stride + static_cast<long long>(b) * m;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + r;
    if (j < m) ob[j] = j < mb ? acc[r] : S(0);
  }
}

// the vjp's pairs of one staged tile; kGuard clamps u^2 (see above)
template <bool kGuard, typename S, int D, int R, typename E>
__device__ __forceinline__ void vjp_pairs(const E* tile, int cnt,
                                          const S (&xi)[R][D],
                                          const S (&nl)[R], S (&a)[R],
                                          S (&cc)[R][D]) {
#pragma unroll 2
  for (int t = 0; t < cnt; ++t) {
    const E e = tile[t];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      S u2[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const S u = e.v[d] - xi[r][d];
        u2[d] = u * u;
      }
      S z = u2[0];
#pragma unroll
      for (int d = 1; d < D; ++d) z += u2[d];
      const S gk = e.v[D] * Exp<S>::of(nl[r] * z);
      a[r] += gk;
#pragma unroll
      for (int d = 0; d < D; ++d)
        cc[r][d] = fma(gk, kGuard ? minimum(u2[d], Limits<S>::huge())
                                  : u2[d], cc[r][d]);
    }
  }
}

// A[b, i] and C[b, :, i] for the R samples i of each thread of this block,
// over the points of split blockIdx.z, into A and C + blockIdx.z *
// split_stride.
template <typename S, int D, int R, int T>
__global__ void __launch_bounds__(T)
    vjp_kernel(const S* __restrict__ x, const S* __restrict__ p,
               long long p_bstride, const S* __restrict__ ih,
               const S* __restrict__ il2, const S* __restrict__ g,
               const int* __restrict__ n_live,
               const int* __restrict__ m_live, S* __restrict__ A,
               S* __restrict__ C, long long split_stride, int n, int m) {
  using E = Pack<S, D + 1>;
  __shared__ E tile[T];
  const int b = blockIdx.y;
  const int nb = live_count(n_live, b, n);
  const int mb = live_count(m_live, b, m);
  const int first = blockIdx.x * (T * R);
  const int i0 = first + threadIdx.x * R;
  S h[D], xi[R][D], nl[R], a[R], cc[R][D];
  const S* xb = x + static_cast<long long>(b) * D * n;
  const S* lb = il2 + static_cast<long long>(b) * n;
  bool big = false;
#pragma unroll
  for (int d = 0; d < D; ++d) h[d] = ih[b * D + d];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    const bool live = i < nb;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xi[r][d] = live ? xb[static_cast<long long>(d) * n + i] * h[d] : S(0);
      big |= !(fabs(xi[r][d]) <= Limits<S>::safe());
      cc[r][d] = S(0);
    }
    nl[r] = live ? Exp<S>::kScale * fmax(lb[i], Limits<S>::tiny()) : S(0);
    a[r] = S(0);
  }
  int lo, hi;
  split_range(mb, T, &lo, &hi);
  if (first < nb && lo < hi) {  // uniform over the block
    const bool active = i0 < nb;
    const S* pb = p + b * p_bstride;
    const S* gb = g + static_cast<long long>(b) * m;
    for (int j0 = lo; j0 < hi; j0 += T) {
      const int j = j0 + threadIdx.x;
      bool bad = big;
      if (j < hi) {
        E e;
#pragma unroll
        for (int w = 0; w < E::kW; ++w) e.v[w] = S(0);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          e.v[d] = pb[static_cast<long long>(d) * m + j] * h[d];
          bad |= !(fabs(e.v[d]) <= Limits<S>::safe());
        }
        e.v[D] = gb[j];
        tile[threadIdx.x] = e;
      }
      const bool guard = __syncthreads_or(bad);
      if (active) {
        const int cnt = min(T, hi - j0);
        if (guard)
          vjp_pairs<true>(tile, cnt, xi, nl, a, cc);
        else
          vjp_pairs<false>(tile, cnt, xi, nl, a, cc);
      }
      __syncthreads();
    }
  }
  const long long nbase = static_cast<long long>(b) * n;
  S* ab = A + blockIdx.z * split_stride + nbase;
  S* cb = C + blockIdx.z * split_stride + nbase * D;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    if (i < n) {
      const bool live = i < nb;
      ab[i] = live ? a[r] : S(0);
#pragma unroll
      for (int d = 0; d < D; ++d)
        cb[static_cast<long long>(d) * n + i] = live ? cc[r][d] : S(0);
    }
  }
}

// the second pass of a split launch: out[e] = sum over s of part[s, e] in
// the order of s, e < e0 into out0, the rest into out1
template <typename S>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_kernel(const S* __restrict__ part, int splits, long long total,
                  long long e0, S* __restrict__ out0,
                  S* __restrict__ out1) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < total; e += step) {
    S s = part[e];
    for (int k = 1; k < splits; ++k) s += part[k * total + e];
    if (e < e0)
      out0[e] = s;
    else
      out1[e - e0] = s;
  }
}

// out[b, j] and dout[b, j] for j of this block (layouts as sum_kernel; one
// thread per point).
template <typename S, int D>
__global__ void __launch_bounds__(kJvpThreads)
    jvp_kernel(const S* __restrict__ x, const S* __restrict__ p,
               long long p_bstride, const S* __restrict__ ih,
               const S* __restrict__ dih, const S* __restrict__ il2,
               const S* __restrict__ dil2, const S* __restrict__ c,
               const S* __restrict__ dc, const int* __restrict__ n_live,
               const int* __restrict__ m_live, S* __restrict__ out,
               S* __restrict__ dout, int n, int m) {
  __shared__ S sx[D][kJvpThreads];
  __shared__ S sl[kJvpThreads];
  __shared__ S sdl[kJvpThreads];
  __shared__ S sc[kJvpThreads];
  __shared__ S sdc[kJvpThreads];
  const int b = blockIdx.y;
  const int nb = live_count(n_live, b, n);
  const int mb = live_count(m_live, b, m);
  const int j = blockIdx.x * kJvpThreads + threadIdx.x;
  S h[D], r[D], pj[D];
  const S* pb = p + b * p_bstride;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    h[d] = ih[b * D + d];
    r[d] = S(2) * dih[b * D + d] / h[d];
    pj[d] = j < mb ? pb[static_cast<long long>(d) * m + j] * h[d] : S(0);
  }
  const long long nbase = static_cast<long long>(b) * n;
  const S* xb = x + nbase * D;
  S acc = S(0), dacc = S(0);
  const int loop_n =
      static_cast<int>(blockIdx.x) * kJvpThreads < mb ? nb : 0;
  for (int i0 = 0; i0 < loop_n; i0 += kJvpThreads) {
    const int i = i0 + threadIdx.x;
    if (i < loop_n) {
#pragma unroll
      for (int d = 0; d < D; ++d)
        sx[d][threadIdx.x] = xb[static_cast<long long>(d) * n + i] * h[d];
      sl[threadIdx.x] = S(-0.5) * fmax(il2[nbase + i], Limits<S>::tiny());
      sdl[threadIdx.x] = S(-0.5) * dil2[nbase + i];
      sc[threadIdx.x] = c[nbase + i];
      sdc[threadIdx.x] = dc[nbase + i];
    }
    __syncthreads();
    const int cnt = min(kJvpThreads, loop_n - i0);
#pragma unroll 2
    for (int t = 0; t < cnt; ++t) {
      S z = S(0), dz = S(0);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const S u = pj[d] - sx[d][t];
        const S u2 = u * u;
        z += u2;
        dz += r[d] * u2;
      }
      const S k = kexp(sl[t] * z);
      acc += sc[t] * k;
      if (k != S(0))
        dacc += k * (sdc[t] + sc[t] * (sdl[t] * z + sl[t] * dz));
    }
    __syncthreads();
  }
  if (j < m) {
    const bool live = j < mb;
    out[static_cast<long long>(b) * m + j] = live ? acc : S(0);
    dout[static_cast<long long>(b) * m + j] = live ? dacc : S(0);
  }
}

inline bool bad_shape(int batch, int n, int m, int splits) {
  return batch <= 0 || batch > 65535 || n < 0 || m < 0 || splits <= 0 ||
         splits > 65535;
}

template <typename S>
void reduce(const S* part, int splits, long long total, long long e0,
            S* out0, S* out1, cudaStream_t s) {
  const long long want = (total + kReduceThreads - 1) / kReduceThreads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  reduce_kernel<S><<<blocks, kReduceThreads, 0, s>>>(part, splits, total, e0,
                                                      out0, out1);
}

template <typename S, int D>
void launch_sum(const S* x, const S* p, long long p_bstride, const S* ih,
                const S* il2, const S* c, const int* n_live,
                const int* m_live, S* dst, long long split_stride, int batch,
                int n, int m, int splits, cudaStream_t s) {
  constexpr int kTile = kSumThreads * kSumR;
  const dim3 grid((m + kTile - 1) / kTile, batch, splits);
  sum_kernel<S, D, kSumR, kSumThreads><<<grid, kSumThreads, 0, s>>>(
      x, p, p_bstride, ih, il2, c, n_live, m_live, dst, split_stride, n, m);
}

// splits > 1 needs scratch of splits * batch * m values
template <typename S>
int sum(const S* x, const S* p, long long p_bstride, const S* ih,
        const S* il2, const S* c, const int* n_live, const int* m_live,
        S* out, S* scratch, int batch, int dims, int n, int m, int splits,
        void* stream) {
  if (bad_shape(batch, n, m, splits) || (splits > 1 && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(batch) * m;
  S* dst = splits > 1 ? scratch : out;
  switch (dims) {
    case 1:
      launch_sum<S, 1>(x, p, p_bstride, ih, il2, c, n_live, m_live, dst,
                       total, batch, n, m, splits, s);
      break;
    case 2:
      launch_sum<S, 2>(x, p, p_bstride, ih, il2, c, n_live, m_live, dst,
                       total, batch, n, m, splits, s);
      break;
    case 3:
      launch_sum<S, 3>(x, p, p_bstride, ih, il2, c, n_live, m_live, dst,
                       total, batch, n, m, splits, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1) reduce<S>(scratch, splits, total, total, out, out, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int D>
void launch_vjp(const S* x, const S* p, long long p_bstride, const S* ih,
                const S* il2, const S* g, const int* n_live,
                const int* m_live, S* a, S* c, long long split_stride,
                int batch, int n, int m, int splits, cudaStream_t s) {
  constexpr int kTile = kVjpThreads * kVjpR;
  const dim3 grid((n + kTile - 1) / kTile, batch, splits);
  vjp_kernel<S, D, kVjpR, kVjpThreads><<<grid, kVjpThreads, 0, s>>>(
      x, p, p_bstride, ih, il2, g, n_live, m_live, a, c, split_stride, n, m);
}

// splits > 1 needs scratch of splits * batch * (1 + dims) * n values
template <typename S>
int vjp(const S* x, const S* p, long long p_bstride, const S* ih,
        const S* il2, const S* g, const int* n_live, const int* m_live, S* A,
        S* C, S* scratch, int batch, int dims, int n, int m, int splits,
        void* stream) {
  if (bad_shape(batch, n, m, splits) || (splits > 1 && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long na = static_cast<long long>(batch) * n;
  const long long total = na * (1 + dims);
  S* a = splits > 1 ? scratch : A;
  S* c = splits > 1 ? scratch + na : C;
  switch (dims) {
    case 1:
      launch_vjp<S, 1>(x, p, p_bstride, ih, il2, g, n_live, m_live, a, c,
                       total, batch, n, m, splits, s);
      break;
    case 2:
      launch_vjp<S, 2>(x, p, p_bstride, ih, il2, g, n_live, m_live, a, c,
                       total, batch, n, m, splits, s);
      break;
    case 3:
      launch_vjp<S, 3>(x, p, p_bstride, ih, il2, g, n_live, m_live, a, c,
                       total, batch, n, m, splits, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1) reduce<S>(scratch, splits, total, na, A, C, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int jvp(const S* x, const S* p, long long p_bstride, const S* ih,
        const S* dih, const S* il2, const S* dil2, const S* c, const S* dc,
        const int* n_live, const int* m_live, S* out, S* dout, int batch,
        int dims, int n, int m, void* stream) {
  if (bad_shape(batch, n, m, 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const dim3 grid((m + kJvpThreads - 1) / kJvpThreads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dims) {
    case 1:
      jvp_kernel<S, 1><<<grid, kJvpThreads, 0, s>>>(
          x, p, p_bstride, ih, dih, il2, dil2, c, dc, n_live, m_live, out,
          dout, n, m);
      break;
    case 2:
      jvp_kernel<S, 2><<<grid, kJvpThreads, 0, s>>>(
          x, p, p_bstride, ih, dih, il2, dil2, c, dc, n_live, m_live, out,
          dout, n, m);
      break;
    case 3:
      jvp_kernel<S, 3><<<grid, kJvpThreads, 0, s>>>(
          x, p, p_bstride, ih, dih, il2, dil2, c, dc, n_live, m_live, out,
          dout, n, m);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int attributes(F* kernel, int threads, int per_thread, int* info) {
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks = 0, device = 0, sms = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                     threads, 0);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  info[0] = a.numRegs;
  info[1] = static_cast<int>(a.localSizeBytes);
  info[2] = static_cast<int>(a.sharedSizeBytes);
  info[3] = threads;
  info[4] = blocks;
  info[5] = per_thread;
  info[6] = sms;
  return static_cast<int>(rc);
}

template <typename S, int D>
int attributes_at(int which, int* info) {
  if (which == 0)
    return attributes(sum_kernel<S, D, kSumR, kSumThreads>, kSumThreads,
                      kSumR, info);
  if (which == 1)
    return attributes(vjp_kernel<S, D, kVjpR, kVjpThreads>, kVjpThreads,
                      kVjpR, info);
  if (which == 2) return attributes(jvp_kernel<S, D>, kJvpThreads, 1, info);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename S>
int attributes_of(int which, int dims, int* info) {
  if (dims == 1) return attributes_at<S, 1>(which, info);
  if (dims == 2) return attributes_at<S, 2>(which, info);
  if (dims == 3) return attributes_at<S, 3>(which, info);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace kde_gauss

// All pointers are device pointers, launched on `stream`, contiguous:
// x (B, D, N), p (D, M) with p_bstride 0 or (B, D, M) with p_bstride D * M,
// ih and dih (B, D), il2, dil2, c and dc (B, N), out, dout and g (B, M),
// A (B, N), C (B, D, N); n_live and m_live (B,) int32 or null (all N, all
// M). The sum and the vjp cut their inner side into `splits` (>= 1; above
// 1 they need `scratch`: splits * B * M values for the sum, splits * B *
// (1 + D) * N for the vjp, and add its parts in a second launch). Each
// entry point returns the cudaError_t of its launches (0 on success); each
// *_attributes fills info (7 ints) for the sum (which = 0), the vjp (which
// = 1) or the jvp (which = 2) at D dims: registers per thread, local bytes
// per thread, shared bytes per block, threads per block, resident blocks
// per SM, outputs per thread and the current card's SMs.
extern "C" int kde_gauss_sum_f32(const float* x, const float* p,
                                 long long p_bstride, const float* ih,
                                 const float* il2, const float* c,
                                 const int* n_live, const int* m_live,
                                 float* out, float* scratch, int batch,
                                 int dims, int n, int m, int splits,
                                 void* stream) {
  return kde_gauss::sum<float>(x, p, p_bstride, ih, il2, c, n_live, m_live,
                               out, scratch, batch, dims, n, m, splits,
                               stream);
}

extern "C" int kde_gauss_sum_f64(const double* x, const double* p,
                                 long long p_bstride, const double* ih,
                                 const double* il2, const double* c,
                                 const int* n_live, const int* m_live,
                                 double* out, double* scratch, int batch,
                                 int dims, int n, int m, int splits,
                                 void* stream) {
  return kde_gauss::sum<double>(x, p, p_bstride, ih, il2, c, n_live, m_live,
                                out, scratch, batch, dims, n, m, splits,
                                stream);
}

extern "C" int kde_gauss_sum_vjp_f32(const float* x, const float* p,
                                     long long p_bstride, const float* ih,
                                     const float* il2, const float* g,
                                     const int* n_live, const int* m_live,
                                     float* A, float* C, float* scratch,
                                     int batch, int dims, int n, int m,
                                     int splits, void* stream) {
  return kde_gauss::vjp<float>(x, p, p_bstride, ih, il2, g, n_live, m_live,
                               A, C, scratch, batch, dims, n, m, splits,
                               stream);
}

extern "C" int kde_gauss_sum_vjp_f64(const double* x, const double* p,
                                     long long p_bstride, const double* ih,
                                     const double* il2, const double* g,
                                     const int* n_live, const int* m_live,
                                     double* A, double* C, double* scratch,
                                     int batch, int dims, int n, int m,
                                     int splits, void* stream) {
  return kde_gauss::vjp<double>(x, p, p_bstride, ih, il2, g, n_live, m_live,
                                A, C, scratch, batch, dims, n, m, splits,
                                stream);
}

extern "C" int kde_gauss_sum_jvp_f32(const float* x, const float* p,
                                     long long p_bstride, const float* ih,
                                     const float* dih, const float* il2,
                                     const float* dil2, const float* c,
                                     const float* dc, const int* n_live,
                                     const int* m_live, float* out,
                                     float* dout, int batch, int dims, int n,
                                     int m, void* stream) {
  return kde_gauss::jvp<float>(x, p, p_bstride, ih, dih, il2, dil2, c, dc,
                               n_live, m_live, out, dout, batch, dims, n, m,
                               stream);
}

extern "C" int kde_gauss_sum_jvp_f64(const double* x, const double* p,
                                     long long p_bstride, const double* ih,
                                     const double* dih, const double* il2,
                                     const double* dil2, const double* c,
                                     const double* dc, const int* n_live,
                                     const int* m_live, double* out,
                                     double* dout, int batch, int dims, int n,
                                     int m, void* stream) {
  return kde_gauss::jvp<double>(x, p, p_bstride, ih, dih, il2, dil2, c, dc,
                                n_live, m_live, out, dout, batch, dims, n, m,
                                stream);
}

extern "C" int kde_gauss_attributes_f32(int which, int dims, int* info) {
  return kde_gauss::attributes_of<float>(which, dims, info);
}

extern "C" int kde_gauss_attributes_f64(int which, int dims, int* info) {
  return kde_gauss::attributes_of<double>(which, dims, info);
}
