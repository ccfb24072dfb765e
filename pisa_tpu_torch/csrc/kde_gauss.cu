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
// The sum: one thread per (b, j) output point. A block stages kThreads
// samples at a time in shared memory, already multiplied by ih (so the
// inner loop is D subtractions, D multiply-adds, one multiply and one exp
// per pair), and keeps the sum in a register. The vjp: one thread per (b, i)
// sample, over tiles of points staged the same way with g. The jvp is the
// sum's loop with the tangents staged beside each sample (dc and -1/2
// dil2) and a second register sum: one pass gives the value and its
// tangent from the same k. It takes one direction a launch; several
// directions (a Jacobian) come as more batch rows (ops/kde.py).
//
// A channel without weight (every c zero) has its bandwidth clamped to
// 1e-30 (utils/kde.py), so ih = 1e30 and u^2 overflows to inf: the sum then
// takes 0 * exp(-inf) = 0, and the vjp skips every term whose k is zero,
// where g k u^2 would be 0 * inf = NaN; the jvp skips such terms of its
// tangent sum for the same reason (k z). Its adaptive widths lambda are
// huge (its pilot is 0), so il2 may underflow to 0 as well, and the
// exponent would be 0 * inf = NaN: both kernels floor il2 at the type's
// smallest normal number as they stage it (once a sample, not in the inner
// loop), so that such a term's k is exp(-inf) = 0. The floor changes no k
// whose il2 is normal.
//
// What bounds it on the card: operations, not bytes. Each pair costs one
// exp and 3D + 2 (sum), 5D + 2 (vjp) or 5D + 9 (jvp) floating-point
// operations, against
// (D + 2) (N + M) values read once. In float32 the exp's MUFU.EX2 (16 a
// clock per SM) is the slower pipe; in float64 the exp is a polynomial on
// the FMA pipe (ops/kde.py:kde_operations counts both). Built without
// fast-math (utils/cuda_build.py), so expf/exp keep full accuracy. The sum
// over N terms runs in the working type.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libkde_gauss.so kde_gauss.cu
// Bound through ctypes (pisa_tpu_torch/ops/kde.py); each launch entry point
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace kde_gauss {

constexpr int kThreads = 256;

__device__ __forceinline__ float kexp(float x) { return expf(x); }
__device__ __forceinline__ double kexp(double x) { return exp(x); }

// the smallest normal number: the floor of the widths il2 (see above)
template <typename S>
__device__ __forceinline__ S tiny();
template <>
__device__ __forceinline__ float tiny<float>() { return 1.17549435e-38f; }
template <>
__device__ __forceinline__ double tiny<double>() {
  return 2.2250738585072014e-308;
}

// out[b, j] for j of this block; p_bstride is 0 when every b shares the
// points, D * M when each has its own.
template <typename S, int D>
__global__ void __launch_bounds__(kThreads)
    sum_kernel(const S* __restrict__ x, const S* __restrict__ p,
               long long p_bstride, const S* __restrict__ ih,
               const S* __restrict__ il2, const S* __restrict__ c,
               S* __restrict__ out, int n, int m) {
  __shared__ S sx[D][kThreads];
  __shared__ S sl[kThreads];
  __shared__ S sc[kThreads];
  const int b = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  S h[D], pj[D];
  const S* pb = p + b * p_bstride;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    h[d] = ih[b * D + d];
    pj[d] = j < m ? pb[static_cast<long long>(d) * m + j] * h[d] : S(0);
  }
  const S* xb = x + static_cast<long long>(b) * D * n;
  const S* lb = il2 + static_cast<long long>(b) * n;
  const S* cb = c + static_cast<long long>(b) * n;
  S acc = S(0);
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    if (i < n) {
#pragma unroll
      for (int d = 0; d < D; ++d)
        sx[d][threadIdx.x] = xb[static_cast<long long>(d) * n + i] * h[d];
      sl[threadIdx.x] = S(-0.5) * fmax(lb[i], tiny<S>());
      sc[threadIdx.x] = cb[i];
    }
    __syncthreads();
    const int cnt = min(kThreads, n - i0);
#pragma unroll 4
    for (int t = 0; t < cnt; ++t) {
      S z = S(0);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const S u = pj[d] - sx[d][t];
        z += u * u;
      }
      acc += sc[t] * kexp(sl[t] * z);
    }
    __syncthreads();
  }
  if (j < m) out[static_cast<long long>(b) * m + j] = acc;
}

// A[b, i] and C[b, :, i] for i of this block.
template <typename S, int D>
__global__ void __launch_bounds__(kThreads)
    vjp_kernel(const S* __restrict__ x, const S* __restrict__ p,
               long long p_bstride, const S* __restrict__ ih,
               const S* __restrict__ il2, const S* __restrict__ g,
               S* __restrict__ A, S* __restrict__ C, int n, int m) {
  __shared__ S sp[D][kThreads];
  __shared__ S sg[kThreads];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  S h[D], xi[D];
  const S* xb = x + static_cast<long long>(b) * D * n;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    h[d] = ih[b * D + d];
    xi[d] = i < n ? xb[static_cast<long long>(d) * n + i] * h[d] : S(0);
  }
  const S nl =
      i < n ? S(-0.5) * fmax(il2[static_cast<long long>(b) * n + i], tiny<S>())
            : S(0);
  const S* pb = p + b * p_bstride;
  const S* gb = g + static_cast<long long>(b) * m;
  S a = S(0), cc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) cc[d] = S(0);
  for (int j0 = 0; j0 < m; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    if (j < m) {
#pragma unroll
      for (int d = 0; d < D; ++d)
        sp[d][threadIdx.x] = pb[static_cast<long long>(d) * m + j] * h[d];
      sg[threadIdx.x] = gb[j];
    }
    __syncthreads();
    const int cnt = min(kThreads, m - j0);
#pragma unroll 2
    for (int t = 0; t < cnt; ++t) {
      S u2[D], z = S(0);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const S u = sp[d][t] - xi[d];
        u2[d] = u * u;
        z += u2[d];
      }
      const S k = kexp(nl * z);
      if (k != S(0)) {
        const S gk = sg[t] * k;
        a += gk;
#pragma unroll
        for (int d = 0; d < D; ++d) cc[d] += gk * u2[d];
      }
    }
    __syncthreads();
  }
  if (i < n) {
    A[static_cast<long long>(b) * n + i] = a;
#pragma unroll
    for (int d = 0; d < D; ++d)
      C[(static_cast<long long>(b) * D + d) * n + i] = cc[d];
  }
}

// out[b, j] and dout[b, j] for j of this block (layouts as sum_kernel).
template <typename S, int D>
__global__ void __launch_bounds__(kThreads)
    jvp_kernel(const S* __restrict__ x, const S* __restrict__ p,
               long long p_bstride, const S* __restrict__ ih,
               const S* __restrict__ dih, const S* __restrict__ il2,
               const S* __restrict__ dil2, const S* __restrict__ c,
               const S* __restrict__ dc, S* __restrict__ out,
               S* __restrict__ dout, int n, int m) {
  __shared__ S sx[D][kThreads];
  __shared__ S sl[kThreads];
  __shared__ S sdl[kThreads];
  __shared__ S sc[kThreads];
  __shared__ S sdc[kThreads];
  const int b = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  S h[D], r[D], pj[D];
  const S* pb = p + b * p_bstride;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    h[d] = ih[b * D + d];
    r[d] = S(2) * dih[b * D + d] / h[d];
    pj[d] = j < m ? pb[static_cast<long long>(d) * m + j] * h[d] : S(0);
  }
  const long long nb = static_cast<long long>(b) * n;
  const S* xb = x + nb * D;
  S acc = S(0), dacc = S(0);
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    if (i < n) {
#pragma unroll
      for (int d = 0; d < D; ++d)
        sx[d][threadIdx.x] = xb[static_cast<long long>(d) * n + i] * h[d];
      sl[threadIdx.x] = S(-0.5) * fmax(il2[nb + i], tiny<S>());
      sdl[threadIdx.x] = S(-0.5) * dil2[nb + i];
      sc[threadIdx.x] = c[nb + i];
      sdc[threadIdx.x] = dc[nb + i];
    }
    __syncthreads();
    const int cnt = min(kThreads, n - i0);
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
    out[static_cast<long long>(b) * m + j] = acc;
    dout[static_cast<long long>(b) * m + j] = dacc;
  }
}

inline bool bad_shape(int batch, int n, int m) {
  return batch <= 0 || batch > 65535 || n < 0 || m < 0;
}

template <typename S>
int sum(const S* x, const S* p, long long p_bstride, const S* ih,
        const S* il2, const S* c, S* out, int batch, int dims, int n, int m,
        void* stream) {
  if (bad_shape(batch, n, m)) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const dim3 grid((m + kThreads - 1) / kThreads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dims) {
    case 1:
      sum_kernel<S, 1><<<grid, kThreads, 0, s>>>(x, p, p_bstride, ih, il2, c,
                                                 out, n, m);
      break;
    case 2:
      sum_kernel<S, 2><<<grid, kThreads, 0, s>>>(x, p, p_bstride, ih, il2, c,
                                                 out, n, m);
      break;
    case 3:
      sum_kernel<S, 3><<<grid, kThreads, 0, s>>>(x, p, p_bstride, ih, il2, c,
                                                 out, n, m);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int vjp(const S* x, const S* p, long long p_bstride, const S* ih,
        const S* il2, const S* g, S* A, S* C, int batch, int dims, int n,
        int m, void* stream) {
  if (bad_shape(batch, n, m)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dims) {
    case 1:
      vjp_kernel<S, 1><<<grid, kThreads, 0, s>>>(x, p, p_bstride, ih, il2, g,
                                                 A, C, n, m);
      break;
    case 2:
      vjp_kernel<S, 2><<<grid, kThreads, 0, s>>>(x, p, p_bstride, ih, il2, g,
                                                 A, C, n, m);
      break;
    case 3:
      vjp_kernel<S, 3><<<grid, kThreads, 0, s>>>(x, p, p_bstride, ih, il2, g,
                                                 A, C, n, m);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int jvp(const S* x, const S* p, long long p_bstride, const S* ih,
        const S* dih, const S* il2, const S* dil2, const S* c, const S* dc,
        S* out, S* dout, int batch, int dims, int n, int m, void* stream) {
  if (bad_shape(batch, n, m)) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const dim3 grid((m + kThreads - 1) / kThreads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dims) {
    case 1:
      jvp_kernel<S, 1><<<grid, kThreads, 0, s>>>(x, p, p_bstride, ih, dih,
                                                 il2, dil2, c, dc, out, dout,
                                                 n, m);
      break;
    case 2:
      jvp_kernel<S, 2><<<grid, kThreads, 0, s>>>(x, p, p_bstride, ih, dih,
                                                 il2, dil2, c, dc, out, dout,
                                                 n, m);
      break;
    case 3:
      jvp_kernel<S, 3><<<grid, kThreads, 0, s>>>(x, p, p_bstride, ih, dih,
                                                 il2, dil2, c, dc, out, dout,
                                                 n, m);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int attributes(F* kernel, int* info) {
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                     kThreads, 0);
  info[0] = a.numRegs;
  info[1] = static_cast<int>(a.localSizeBytes);
  info[2] = static_cast<int>(a.sharedSizeBytes);
  info[3] = kThreads;
  info[4] = blocks;
  return static_cast<int>(rc);
}

template <typename S>
int attributes_of(int which, int dims, int* info) {
  if (which == 0) {
    if (dims == 1) return attributes(sum_kernel<S, 1>, info);
    if (dims == 2) return attributes(sum_kernel<S, 2>, info);
    if (dims == 3) return attributes(sum_kernel<S, 3>, info);
  } else if (which == 1) {
    if (dims == 1) return attributes(vjp_kernel<S, 1>, info);
    if (dims == 2) return attributes(vjp_kernel<S, 2>, info);
    if (dims == 3) return attributes(vjp_kernel<S, 3>, info);
  } else if (which == 2) {
    if (dims == 1) return attributes(jvp_kernel<S, 1>, info);
    if (dims == 2) return attributes(jvp_kernel<S, 2>, info);
    if (dims == 3) return attributes(jvp_kernel<S, 3>, info);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace kde_gauss

// All pointers are device pointers, launched on `stream`, contiguous:
// x (B, D, N), p (D, M) with p_bstride 0 or (B, D, M) with p_bstride D * M,
// ih and dih (B, D), il2, dil2, c and dc (B, N), out, dout and g (B, M),
// A (B, N), C (B, D, N). Each launch returns the cudaError_t of its launch
// (0 on success); each *_attributes fills info (5 ints) for the sum (which
// = 0), the vjp (which = 1) or the jvp (which = 2) at D dims: registers
// per thread, local bytes per thread,
// shared bytes per block, threads per block and resident blocks per SM.
extern "C" int kde_gauss_sum_f32(const float* x, const float* p,
                                 long long p_bstride, const float* ih,
                                 const float* il2, const float* c, float* out,
                                 int batch, int dims, int n, int m,
                                 void* stream) {
  return kde_gauss::sum<float>(x, p, p_bstride, ih, il2, c, out, batch, dims,
                               n, m, stream);
}

extern "C" int kde_gauss_sum_f64(const double* x, const double* p,
                                 long long p_bstride, const double* ih,
                                 const double* il2, const double* c,
                                 double* out, int batch, int dims, int n,
                                 int m, void* stream) {
  return kde_gauss::sum<double>(x, p, p_bstride, ih, il2, c, out, batch,
                                dims, n, m, stream);
}

extern "C" int kde_gauss_sum_vjp_f32(const float* x, const float* p,
                                     long long p_bstride, const float* ih,
                                     const float* il2, const float* g,
                                     float* A, float* C, int batch, int dims,
                                     int n, int m, void* stream) {
  return kde_gauss::vjp<float>(x, p, p_bstride, ih, il2, g, A, C, batch, dims,
                               n, m, stream);
}

extern "C" int kde_gauss_sum_vjp_f64(const double* x, const double* p,
                                     long long p_bstride, const double* ih,
                                     const double* il2, const double* g,
                                     double* A, double* C, int batch,
                                     int dims, int n, int m, void* stream) {
  return kde_gauss::vjp<double>(x, p, p_bstride, ih, il2, g, A, C, batch,
                                dims, n, m, stream);
}

extern "C" int kde_gauss_sum_jvp_f32(const float* x, const float* p,
                                     long long p_bstride, const float* ih,
                                     const float* dih, const float* il2,
                                     const float* dil2, const float* c,
                                     const float* dc, float* out, float* dout,
                                     int batch, int dims, int n, int m,
                                     void* stream) {
  return kde_gauss::jvp<float>(x, p, p_bstride, ih, dih, il2, dil2, c, dc,
                               out, dout, batch, dims, n, m, stream);
}

extern "C" int kde_gauss_sum_jvp_f64(const double* x, const double* p,
                                     long long p_bstride, const double* ih,
                                     const double* dih, const double* il2,
                                     const double* dil2, const double* c,
                                     const double* dc, double* out,
                                     double* dout, int batch, int dims, int n,
                                     int m, void* stream) {
  return kde_gauss::jvp<double>(x, p, p_bstride, ih, dih, il2, dil2, c, dc,
                                out, dout, batch, dims, n, m, stream);
}

extern "C" int kde_gauss_attributes_f32(int which, int dims, int* info) {
  return kde_gauss::attributes_of<float>(which, dims, info);
}

extern "C" int kde_gauss_attributes_f64(int which, int dims, int* info) {
  return kde_gauss::attributes_of<double>(which, dims, info);
}
