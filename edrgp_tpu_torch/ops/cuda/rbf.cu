// Hand-written Hopper (sm_90a) kernels for the RBF hot path of the exact-GP
// EDR loop.  Built by _build.py with nvcc into a shared library with a plain
// C interface and bound with ctypes by rbf.py.  Every kernel runs in fp32 on
// the caller's stream, allocates nothing and does not synchronise; each
// launcher returns cudaGetLastError() so the wrapper can raise on a refused
// launch.
//
// The three kernels replace the Pallas TPU kernels of
// edrgp_tpu/ops/pallas/rbf.py.  What differs from the TPU versions:
//   * distances are the direct sum of (a - b)^2 in fp32 FMAs, never the
//     ||a||^2 + ||b||^2 - 2ab matmul trick: Q is small (1 to ~64), so the
//     direct form is cheap and does not cancel;
//   * the sequential (i, j) grid with a pl.when(j == 0) revisit becomes one
//     block per row tile that loops over the column tiles itself, with the
//     per-row sums in shared memory: no atomics, deterministic;
//   * ragged edges are masked, not padded.
// Any Q works as long as the shared-memory tiles fit; a launch whose tiles
// do not fit is refused with cudaErrorInvalidValue.

#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// K: out[m, n] = sigma2 * exp(-0.5 * ||x1_m - x2_n||^2) on pre-scaled inputs.
// Replaces rbf_kernel_matrix (edrgp_tpu/ops/pallas/rbf.py:84).  Bound by the
// M*N*4 bytes it writes; each block computes a 64x64 output tile (4x4 per
// thread) from Q-chunks of both input tiles staged in shared memory, so every
// input element is read M/64 + N/64 times in all and every output once.
// ---------------------------------------------------------------------------
constexpr int K_TILE = 64;
constexpr int K_EDGE = 16;  // threads per tile edge
constexpr int K_QCHUNK = 16;

__global__ void kmat_kernel(const float* __restrict__ x1,
                            const float* __restrict__ x2,
                            const float* __restrict__ sigma2,
                            float* __restrict__ out, int M, int N, int Q) {
  __shared__ float a_s[K_QCHUNK][K_TILE + 1];
  __shared__ float b_s[K_QCHUNK][K_TILE + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * K_EDGE + tx;
  const int row0 = blockIdx.y * K_TILE, col0 = blockIdx.x * K_TILE;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int q0 = 0; q0 < Q; q0 += K_QCHUNK) {
    const int qn = min(K_QCHUNK, Q - q0);
    for (int e = tid; e < K_TILE * qn; e += K_EDGE * K_EDGE) {
      const int r = e / qn, q = e % qn;
      const int gr = row0 + r, gc = col0 + r;
      a_s[q][r] = gr < M ? x1[(size_t)gr * Q + q0 + q] : 0.f;
      b_s[q][r] = gc < N ? x2[(size_t)gc * Q + q0 + q] : 0.f;
    }
    __syncthreads();
    for (int q = 0; q < qn; ++q) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[q][ty + K_EDGE * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[q][tx + K_EDGE * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float d = a[i] - b[j];
          acc[i][j] = fmaf(d, d, acc[i][j]);
        }
    }
    __syncthreads();
  }

  const float s2 = *sigma2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + K_EDGE * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + K_EDGE * j;
      if (c < N) out[(size_t)r * N + c] = s2 * expf(-0.5f * acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// G: out[m, :] = sum_i alpha_i k(xs_m, xt_i) (xt_i - xs_m) in scaled
// coordinates (the wrapper divides by the lengthscale).  Replaces
// rbf_grad_mu (edrgp_tpu/ops/pallas/rbf.py:147).  Bound by shared-memory
// traffic (about 6Q accesses per (m, i) pair); device-memory traffic is
// O((M + N) Q) because the [M, N] cross-kernel never leaves the SM.  One
// thread owns one test row: its scaled row and its Q sums sit in shared
// memory laid out [Q][G_ROWS] (conflict-free), and the block walks all
// training rows in staged tiles of G_TN rows, read by every thread at the
// same address (broadcast).  Accumulating w * (xt - xs) directly, instead of
// the TPU kernel's sum(w xt) - xs sum(w), avoids a cancellation.
// ---------------------------------------------------------------------------
constexpr int G_ROWS = 64;
constexpr int G_TN = 64;

__global__ void gradmu_kernel(const float* __restrict__ xs,
                              const float* __restrict__ xt,
                              const float* __restrict__ alpha,
                              const float* __restrict__ sigma2,
                              float* __restrict__ out, int M, int N, int Q) {
  extern __shared__ float smem[];
  float* xs_s = smem;                  // [Q][G_ROWS]
  float* acc_s = xs_s + Q * G_ROWS;    // [Q][G_ROWS]
  float* xt_s = acc_s + Q * G_ROWS;    // [G_TN][Q]
  float* al_s = xt_s + G_TN * Q;       // [G_TN]
  const int t = threadIdx.x;
  const int m = blockIdx.x * G_ROWS + t;
  const bool live = m < M;
  for (int q = 0; q < Q; ++q) {
    xs_s[q * G_ROWS + t] = live ? xs[(size_t)m * Q + q] : 0.f;
    acc_s[q * G_ROWS + t] = 0.f;
  }
  const float s2 = *sigma2;

  for (int j0 = 0; j0 < N; j0 += G_TN) {
    const int nt = min(G_TN, N - j0);
    __syncthreads();
    for (int e = t; e < nt * Q; e += G_ROWS) xt_s[e] = xt[(size_t)j0 * Q + e];
    for (int e = t; e < nt; e += G_ROWS) al_s[e] = alpha[j0 + e];
    __syncthreads();
    for (int i = 0; i < nt; ++i) {
      const float* xi = xt_s + i * Q;
      float sq = 0.f;
      for (int q = 0; q < Q; ++q) {
        const float d = xi[q] - xs_s[q * G_ROWS + t];
        sq = fmaf(d, d, sq);
      }
      const float w = s2 * expf(-0.5f * sq) * al_s[i];
      for (int q = 0; q < Q; ++q) {
        float* a = acc_s + q * G_ROWS + t;
        *a = fmaf(w, xi[q] - xs_s[q * G_ROWS + t], *a);
      }
    }
  }
  if (live)
    for (int q = 0; q < Q; ++q) out[(size_t)m * Q + q] = acc_s[q * G_ROWS + t];
}

// ---------------------------------------------------------------------------
// A: with Aij = W[i, j] * sigma2 * exp(-0.5 ||xs_i - xs_j||^2),
// P[i, :] = sum_j Aij xs_j and r[i] = sum_j Aij.  Replaces rbf_nlml_adjoint
// (edrgp_tpu/ops/pallas/rbf.py:236).  Bound by reading the N*N*4 bytes of W
// once; K is recomputed per pair and never stored.  One warp owns one row i
// and its lanes walk the row's columns, so W is read coalesced, 128 bytes per
// warp step.  The block's A_WARPS rows share a staged tile of A_TJ scaled
// rows, stored with an odd stride so the lanes' reads do not conflict; each
// lane keeps its partial P row in shared memory ([warp][Q][32], conflict-
// free) and the warp reduces with shuffles once at the end.
// ---------------------------------------------------------------------------
constexpr int A_WARPS = 8;
constexpr int A_TJ = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void nlml_adjoint_kernel(const float* __restrict__ xs,
                                    const float* __restrict__ W,
                                    const float* __restrict__ sigma2,
                                    float* __restrict__ P,
                                    float* __restrict__ r, int N, int Q) {
  extern __shared__ float smem[];
  const int Qp = Q | 1;                      // odd stride: no bank conflicts
  float* xj_s = smem;                        // [A_TJ][Qp]
  float* xi_s = xj_s + A_TJ * Qp;            // [A_WARPS][Q]
  float* p_s = xi_s + A_WARPS * Q;           // [A_WARPS][Q][32]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * A_WARPS + warp;
  const bool live = i < N;
  float* xi = xi_s + warp * Q;
  float* pw = p_s + warp * Q * 32;
  for (int q = lane; q < Q; q += 32) xi[q] = live ? xs[(size_t)i * Q + q] : 0.f;
  for (int q = 0; q < Q; ++q) pw[q * 32 + lane] = 0.f;
  float r_acc = 0.f;
  const float s2 = *sigma2;
  const float* wrow = W + (size_t)(live ? i : 0) * N;

  for (int j0 = 0; j0 < N; j0 += A_TJ) {
    const int nt = min(A_TJ, N - j0);
    __syncthreads();
    for (int e = threadIdx.x; e < nt * Q; e += blockDim.x) {
      const int c = e / Q, q = e % Q;
      xj_s[c * Qp + q] = xs[(size_t)j0 * Q + e];
    }
    __syncthreads();
    if (!live) continue;
    for (int c = lane; c < nt; c += 32) {
      const float* xj = xj_s + c * Qp;
      float sq = 0.f;
      for (int q = 0; q < Q; ++q) {
        const float d = xi[q] - xj[q];
        sq = fmaf(d, d, sq);
      }
      const float a = wrow[j0 + c] * (s2 * expf(-0.5f * sq));
      r_acc += a;
      for (int q = 0; q < Q; ++q)
        pw[q * 32 + lane] = fmaf(a, xj[q], pw[q * 32 + lane]);
    }
  }

  r_acc = warp_sum(r_acc);
  for (int q = 0; q < Q; ++q) {
    const float v = warp_sum(pw[q * 32 + lane]);
    if (lane == 0 && live) P[(size_t)i * Q + q] = v;
  }
  if (lane == 0 && live) r[i] = r_acc;
}

size_t gradmu_smem(int Q) {
  return sizeof(float) * ((size_t)2 * Q * G_ROWS + (size_t)G_TN * Q + G_TN);
}

size_t adjoint_smem(int Q) {
  return sizeof(float) * ((size_t)A_TJ * (Q | 1) + (size_t)A_WARPS * Q +
                          (size_t)A_WARPS * Q * 32);
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)limit) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

const char* edrgp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int edrgp_rbf_kernel_matrix(const float* x1, const float* x2,
                            const float* sigma2, float* out, int M, int N,
                            int Q, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const dim3 grid((N + K_TILE - 1) / K_TILE, (M + K_TILE - 1) / K_TILE);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kmat_kernel<<<grid, dim3(K_EDGE, K_EDGE), 0, (cudaStream_t)stream>>>(
      x1, x2, sigma2, out, M, N, Q);
  return (int)cudaGetLastError();
}

int edrgp_rbf_grad_mu(const float* xs, const float* xt, const float* alpha,
                      const float* sigma2, float* out, int M, int N, int Q,
                      void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  const size_t smem = gradmu_smem(Q);
  cudaError_t err = allow_smem(gradmu_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + G_ROWS - 1) / G_ROWS;
  gradmu_kernel<<<blocks, G_ROWS, smem, (cudaStream_t)stream>>>(
      xs, xt, alpha, sigma2, out, M, N, Q);
  return (int)cudaGetLastError();
}

int edrgp_rbf_nlml_adjoint(const float* xs, const float* W,
                           const float* sigma2, float* P, float* r, int N,
                           int Q, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  const size_t smem = adjoint_smem(Q);
  cudaError_t err = allow_smem(nlml_adjoint_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + A_WARPS - 1) / A_WARPS;
  nlml_adjoint_kernel<<<blocks, A_WARPS * 32, smem, (cudaStream_t)stream>>>(
      xs, W, sigma2, P, r, N, Q);
  return (int)cudaGetLastError();
}

}  // extern "C"
