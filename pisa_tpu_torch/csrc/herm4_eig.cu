// Eigenvalues and eigenvectors of batched 4x4 complex Hermitian matrices for
// NVIDIA Hopper (sm_90a): cyclic Jacobi in registers, one thread a matrix,
// its block's matrices staged through shared memory, float32 and float64.
//
// Not a port of a Pallas kernel. It is the card's counterpart of the XLA
// eigvalsh call of pisa_tpu/ops/osc/sterile.py:_eigvals_hermitian4, which
// takes the eigenvalues of each 3+1 layer step's Hamiltonian (there through
// an 8x8 real-symmetric embedding, because the TPU has no complex types).
// The library route on the card, torch.linalg.eigvalsh, waits for the host
// (it checks for convergence failure on the CPU), so a CUDA graph cannot
// capture it; this kernel reads nothing back and can be captured.
//
// The math. The Hermitian part (A + A^H) / 2, as the JAX package
// symmetrizes its embedding, divided by its largest entry (Jacobi is
// scale-invariant; this keeps every intermediate far from float32's
// underflow and overflow at any energy). Then cyclic sweeps over the six
// planes (p, q): a complex Givens rotation G = [[c, s e^{i phi}], [-s
// e^{-i phi}, c]] with a_pq = r e^{i phi} and t = s / c the smaller root of
// t^2 + 2 tau t - 1 = 0, tau = (a_qq - a_pp) / (2 r), annihilates a_pq (A <-
// G^H A G, V <- V G); rotation_of forms it with one sqrt, one division and
// one rsqrt. Sweeps stop once the off-diagonal mass is below eps^2 of the
// diagonal's (eps the type's machine epsilon); Jacobi converges
// quadratically, a few sweeps at 4x4. The eigenvalues are sorted ascending,
// with V's columns, and scaled back.
//
// What bounds it on the card: 272 bytes of matrix in and out in float32
// (544 in float64) against ~3,000 floating-point operations a matrix (3-4
// sweeps; ops/osc/herm4.py:herm4_operations), a few hundred instructions a
// sweep with a sqrt, an rsqrt and a division in each rotation's dependency
// chain. The design (herm4_thread_kernel): a block's 128 matrices are one
// contiguous span (16 KB in float32), loaded and stored through shared
// memory as 16-byte words, consecutive threads on consecutive words (one
// thread reading its own 128 bytes touched 32 cache lines a warp-wide
// load); each thread then runs solve() on its matrix in registers. On an
// H100 at the 3+1 flagship's 279,600 matrices this took 0.187 ms to 0.047
// ms in float32 (48% of the bytes bound; 0.209 to 0.099 ms in float64;
// scripts/tune_herm4.py, PERF.md).
//
// A design of four lanes a matrix (a column of A a lane, a sweep as three
// rounds of two disjoint rotations exchanged by shuffles) converged in
// fewer sweeps but ran about twice the instructions a matrix and lost on
// the same card (PERF.md), so it is not kept.
//
// Outputs: the eigenvalues in ascending order, (n, 4) real, which the 3+1
// layer step needs sorted (its deflation picks the isolated state and the
// cluster extreme from neighbouring gaps, sterile.py:194, :228); the
// eigenvectors, (n, 4, 4) complex with the eigenvectors as columns, as
// torch.linalg.eigh gives them, which only the derivatives read (their
// phases are the rotations', not eigh's); and, where the pointer is not
// null, the sweeps each matrix took (int32), from which chip_smoke.py
// counts the operations behind the kernel's bound.
//
// solve() is __host__ __device__ over any scalar type: the host tests
// (tests/test_torch_herm4_source.py) compile it with the C++ compiler and
// check it against numpy and count its operations.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libherm4_eig.so herm4_eig.cu
// Bound through ctypes (pisa_tpu_torch/ops/osc/herm4.py); each launch entry
// point returns cudaGetLastError() after its launch.

#include <cmath>
#include <cstddef>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define H4_HD __host__ __device__ __forceinline__
#else
#define H4_HD inline
#endif

namespace herm4 {

constexpr int kThreads = 128;   // threads of a block
constexpr int kMaxSweeps = 16;  // a bound only: 4x4 converges in 4-6

// -- precision-dispatched math (device intrinsics on the card, std on host) --
H4_HD float h4_sqrt(float x) { return sqrtf(x); }
H4_HD double h4_sqrt(double x) { return sqrt(x); }
H4_HD float h4_fabs(float x) { return fabsf(x); }
H4_HD double h4_fabs(double x) { return fabs(x); }
H4_HD float h4_rsqrt(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}
H4_HD double h4_rsqrt(double x) {
#ifdef __CUDA_ARCH__
  return rsqrt(x);
#else
  return 1.0 / sqrt(x);
#endif
}
H4_HD float value(float x) { return x; }
H4_HD double value(double x) { return x; }

// The rotation of the pair (p, q) with dlt = a_qq - a_pp and a_pq = xr + i
// xi, r2 = |a_pq|^2 > 0: c, s e^{i phi} = (sr, si) and t r. t = s / c is the
// smaller root of t^2 + 2 tau t - 1 = 0, tau = dlt / (2 r), written as t =
// sgn(dlt) 2 r / (|dlt| + sqrt(dlt^2 + 4 r^2)) = q r, so that one sqrt and
// one division give t^2 = q^2 r^2, s e^{i phi} = t c e^{i phi} = c q (xr +
// i xi) and t r = q r^2; the entries are scaled to at most 1, so nothing
// here overflows.
template <typename S>
H4_HD void rotation_of(S dlt, S xr, S xi, S r2, S& c, S& sr, S& si, S& tr) {
  const S inv = S(1) / (h4_fabs(dlt) + h4_sqrt(dlt * dlt + S(4) * r2));
  S q = S(2) * inv;
  if (value(dlt) < 0) q = -q;
  c = h4_rsqrt(S(1) + q * q * r2);
  const S cq = c * q;
  sr = cq * xr;
  si = cq * xi;
  tr = q * r2;
}

// A Hermitian matrix (both triangles kept) and the eigenvectors found so far
// (columns), split into real and imaginary parts.
template <typename S>
struct Herm4 {
  S ar[4][4], ai[4][4];
  S vr[4][4], vi[4][4];
};

// The entries (x, y) of columns P and Q in one row after A <- A G, with
// (sr, si) = s e^{i phi}: x <- c x - s e^{-i phi} y, y <- s e^{i phi} x + c y.
template <typename S>
H4_HD void rotate_pair(S& xr, S& xi, S& yr, S& yi, S c, S sr, S si) {
  const S nxr = c * xr - (sr * yr + si * yi);
  const S nxi = c * xi - (sr * yi - si * yr);
  const S nyr = (sr * xr - si * xi) + c * yr;
  const S nyi = (sr * xi + si * xr) + c * yi;
  xr = nxr;
  xi = nxi;
  yr = nyr;
  yi = nyi;
}

// One Jacobi rotation in the (P, Q) plane, annihilating a_PQ.
template <int P, int Q, typename S>
H4_HD void rotate(Herm4<S>& h) {
  const S xr = h.ar[P][Q], xi = h.ai[P][Q];
  const S r2 = xr * xr + xi * xi;
  if (!(value(r2) > 0)) return;
  const S a = h.ar[P][P], b = h.ar[Q][Q];
  S c, sr, si, tr;
  rotation_of(b - a, xr, xi, r2, c, sr, si, tr);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k == P || k == Q) continue;
    rotate_pair(h.ar[k][P], h.ai[k][P], h.ar[k][Q], h.ai[k][Q], c, sr, si);
    h.ar[P][k] = h.ar[k][P];
    h.ai[P][k] = -h.ai[k][P];
    h.ar[Q][k] = h.ar[k][Q];
    h.ai[Q][k] = -h.ai[k][Q];
  }
  h.ar[P][P] = a - tr;
  h.ar[Q][Q] = b + tr;
  h.ar[P][Q] = h.ai[P][Q] = h.ar[Q][P] = h.ai[Q][P] = S(0);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    rotate_pair(h.vr[k][P], h.vi[k][P], h.vr[k][Q], h.vi[k][Q], c, sr, si);
}

// Swap eigenpairs i and j where d[i] > d[j] (a step of the sorting network).
template <int I, int J, typename S>
H4_HD void order(S (&d)[4], Herm4<S>& h) {
  if (!(value(d[I]) > value(d[J]))) return;
  const S t = d[I];
  d[I] = d[J];
  d[J] = t;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const S r = h.vr[k][I], i = h.vi[k][I];
    h.vr[k][I] = h.vr[k][J];
    h.vi[k][I] = h.vi[k][J];
    h.vr[k][J] = r;
    h.vi[k][J] = i;
  }
}

// The eigen-decomposition of the 4x4 matrix `m` (interleaved complex,
// row-major: m[2 (4 i + j)] = Re a_ij, m[2 (4 i + j) + 1] = Im a_ij) of its
// Hermitian part: the eigenvalues in ascending order into w (4), the
// eigenvectors as columns into v (interleaved complex, row-major, 32).
// `tol2` is the squared relative tolerance of the off-diagonal mass.
// Returns the number of sweeps.
template <typename S>
H4_HD int solve(const S* m, S tol2, S* w, S* v) {
  Herm4<S> h;
  S scale = S(0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h.ar[i][i] = m[2 * (5 * i)];
    h.ai[i][i] = S(0);
    if (value(h4_fabs(h.ar[i][i])) > value(scale)) scale = h4_fabs(h.ar[i][i]);
#pragma unroll
    for (int j = i + 1; j < 4; ++j) {
      const S re = S(0.5) * (m[2 * (4 * i + j)] + m[2 * (4 * j + i)]);
      const S im = S(0.5) * (m[2 * (4 * i + j) + 1] - m[2 * (4 * j + i) + 1]);
      h.ar[i][j] = h.ar[j][i] = re;
      h.ai[i][j] = im;
      h.ai[j][i] = -im;
      if (value(h4_fabs(re)) > value(scale)) scale = h4_fabs(re);
      if (value(h4_fabs(im)) > value(scale)) scale = h4_fabs(im);
    }
  }
  const bool nonzero = value(scale) > 0;
  if (nonzero) {
    const S inv = S(1) / scale;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h.ar[i][j] = h.ar[i][j] * inv;
        h.ai[i][j] = h.ai[i][j] * inv;
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h.vr[i][j] = S(i == j ? 1 : 0);
      h.vi[i][j] = S(0);
    }
  int sweeps = 0;
  for (; sweeps < kMaxSweeps; ++sweeps) {
    S off = h.ar[0][1] * h.ar[0][1] + h.ai[0][1] * h.ai[0][1];
    off = off + (h.ar[0][2] * h.ar[0][2] + h.ai[0][2] * h.ai[0][2]);
    off = off + (h.ar[0][3] * h.ar[0][3] + h.ai[0][3] * h.ai[0][3]);
    off = off + (h.ar[1][2] * h.ar[1][2] + h.ai[1][2] * h.ai[1][2]);
    off = off + (h.ar[1][3] * h.ar[1][3] + h.ai[1][3] * h.ai[1][3]);
    off = off + (h.ar[2][3] * h.ar[2][3] + h.ai[2][3] * h.ai[2][3]);
    S diag = h.ar[0][0] * h.ar[0][0] + h.ar[1][1] * h.ar[1][1];
    diag = diag + (h.ar[2][2] * h.ar[2][2] + h.ar[3][3] * h.ar[3][3]);
    // also stops on a NaN input
    if (!(value(off) > value(tol2 * diag))) break;
    rotate<0, 1>(h);
    rotate<0, 2>(h);
    rotate<0, 3>(h);
    rotate<1, 2>(h);
    rotate<1, 3>(h);
    rotate<2, 3>(h);
  }
  S d[4] = {h.ar[0][0], h.ar[1][1], h.ar[2][2], h.ar[3][3]};
  order<0, 1>(d, h);
  order<2, 3>(d, h);
  order<0, 2>(d, h);
  order<1, 3>(d, h);
  order<1, 2>(d, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = nonzero ? d[i] * scale : d[i];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * (4 * i + j)] = h.vr[i][j];
      v[2 * (4 * i + j) + 1] = h.vi[i][j];
    }
  return sweeps;
}

#ifdef __CUDACC__
// a matrix's row in shared memory: 32 scalars padded by one 16-byte word
template <typename S>
struct Staged {
  static constexpr int kPer = 16 / sizeof(S);  // scalars a word
  static constexpr int kWords = 32 / kPer;     // words a matrix
  static constexpr int kStride = 32 + kPer;
};
struct alignas(16) Word {
  unsigned u[4];
};

// the block's matrices from first on, m -> shared (16-byte words,
// consecutive threads on consecutive words); zeros past n
template <typename S>
__device__ __forceinline__ void stage_in(const S* __restrict__ m,
                                         long long first, long long n,
                                         S* sm) {
  using T = Staged<S>;
  const Word* src = reinterpret_cast<const Word*>(m + 32 * first);
  for (int k = threadIdx.x; k < kThreads * T::kWords; k += kThreads) {
    const int mi = k / T::kWords, wo = k % T::kWords;
    Word word = {{0u, 0u, 0u, 0u}};
    if (first + mi < n) word = src[k];
    *reinterpret_cast<Word*>(sm + mi * T::kStride + wo * T::kPer) = word;
  }
}

// shared -> v, the matrices below n
template <typename S>
__device__ __forceinline__ void stage_out(const S* sm, long long first,
                                          long long n, S* __restrict__ v) {
  using T = Staged<S>;
  Word* dst = reinterpret_cast<Word*>(v + 32 * first);
  for (int k = threadIdx.x; k < kThreads * T::kWords; k += kThreads) {
    const int mi = k / T::kWords, wo = k % T::kWords;
    if (first + mi < n)
      dst[k] = *reinterpret_cast<const Word*>(sm + mi * T::kStride +
                                              wo * T::kPer);
  }
}

// one thread a matrix (solve), its block's matrices staged through shared
// memory
template <typename S>
__global__ void __launch_bounds__(kThreads)
    herm4_thread_kernel(const S* __restrict__ m, S* __restrict__ w,
                        S* __restrict__ v, int* __restrict__ sweeps,
                        long long n, S tol2) {
  constexpr int kStride = Staged<S>::kStride;
  __shared__ Word words[kThreads * kStride / Staged<S>::kPer];
  S* sm = reinterpret_cast<S*>(words);
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  stage_in<S>(m, first, n, sm);
  __syncthreads();
  S* a = sm + threadIdx.x * kStride;
  S wl[4], vl[32];
  const int s = solve(a, tol2, wl, vl);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 32; ++k) a[k] = vl[k];
  const long long i = first + threadIdx.x;
  if (i < n) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[4 * i + k] = wl[k];
    if (sweeps != nullptr) sweeps[i] = s;
  }
  __syncthreads();
  stage_out<S>(sm, first, n, v);
}

template <typename S>
int launch(const S* m, S* w, S* v, int* sweeps, long long n, S eps,
           void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  herm4_thread_kernel<S><<<grid, kThreads, 0, s>>>(m, w, v, sweeps, n,
                                                   eps * eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int attributes(int* info) {
  const auto kernel = herm4_thread_kernel<S>;
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
#endif  // __CUDACC__

}  // namespace herm4

#ifdef __CUDACC__
// All pointers are device pointers, launched on `stream`: m (n, 4, 4)
// complex (interleaved re, im; 16-byte aligned), w (n, 4), v (n, 4, 4)
// complex (16-byte aligned), sweeps (n,) int32 or null. Each launch returns
// the cudaError_t of its launch (0 on success); each *_attributes fills
// info (5 ints): registers per thread, local bytes per thread, shared bytes
// per block, threads per block and resident blocks per SM.
extern "C" int herm4_eig_f32(const float* m, float* w, float* v, int* sweeps,
                             long long n, void* stream) {
  return herm4::launch<float>(m, w, v, sweeps, n, 1.1920928955078125e-07f,
                              stream);
}

extern "C" int herm4_eig_f64(const double* m, double* w, double* v,
                             int* sweeps, long long n, void* stream) {
  return herm4::launch<double>(m, w, v, sweeps, n, 2.220446049250313e-16,
                               stream);
}

extern "C" int herm4_eig_attributes_f32(int* info) {
  return herm4::attributes<float>(info);
}

extern "C" int herm4_eig_attributes_f64(int* info) {
  return herm4::attributes<double>(info);
}
#endif  // __CUDACC__
