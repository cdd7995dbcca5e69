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
//   * the sequential (i, j) grid with a pl.when(j == 0) revisit becomes a
//     loop over column tiles inside a block; where one row tile per block
//     cannot fill the card (A), the columns are split over blocks and the
//     per-split partial sums are added in a fixed order by a second kernel:
//     no atomics, so two launches on the same inputs agree bit for bit;
//   * ragged edges are masked (or zero-filled by TMA), not padded;
//   * no tensor cores: Q is rarely a multiple of 8, and fp32 accuracy on
//     them would need a 3xTF32 split (see A below).
// Any Q works as long as the shared-memory tiles fit; a launch whose tiles
// do not fit is refused with cudaErrorInvalidValue.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// exp(-d2 / 2) = exp2(-kHalfLog2e * d2).
constexpr float kHalfLog2e = 0.721347520444481703680f;

// One MUFU.EX2; inputs below -126 flush to 0, far below the tolerances.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies of 4 and 16 bytes.  Only the first
// `bytes` (16-byte copy) or, with live true, 4 (4-byte copy) are read; the
// rest of the destination is zero-filled.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// mbarriers in shared memory: a phase completes when the expected arrivals
// (and, after expect_tx, bytes) have come; waits name the phase's parity.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Arrive on bar once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(smem_u32(bar))
               : "memory");
}

// Spins until the phase of the given parity has completed; a phase that
// never completes (a fault in the pipeline) traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == (1 << 26)) __trap();
  }
}

// One TMA box of `map` at (column x, row y) into dst, counted on bar.
__device__ __forceinline__ void tma_load_2d(float* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x),
      "r"(y)
      : "memory");
}

// ---------------------------------------------------------------------------
// K: out[m, n] = sigma2 * exp(-0.5 * ||x1_m - x2_n||^2) on pre-scaled inputs.
// Replaces rbf_kernel_matrix (edrgp_tpu/ops/pallas/rbf.py:84, pallas_call at
// :98).  Bound on the H100 by the M*N*4 bytes it writes (0.080 ms at 8192^2
// for 3.35 TB/s; the (3Q+2)*M*N flops take 0.032 ms at Q=10).  So the
// design is about the stores: each thread owns 8 rows x 4 consecutive
// columns and writes each row's 4 values as one 16-byte streaming store
// (__stcs: the output is larger than the 50 MB L2 and is read later by
// another kernel), so a warp writes 512 contiguous bytes per row.  A block
// computes a 64 x 128 tile from Q-chunks of both input tiles staged in
// shared memory ([Q][rows], read as broadcast or contiguous float4); the
// 8x4 register tile amortises the staging and its __syncthreads.  The
// symmetry of K(X, X) is not used: the writes, not the arithmetic, bound it.
// ---------------------------------------------------------------------------
constexpr int K_BM = 64;    // rows per block: 8 warps x K_TM
constexpr int K_BN = 128;   // columns per block: 32 lanes x 4
constexpr int K_TM = 8;     // rows per thread
constexpr int K_QC = 16;    // coordinates staged per chunk
constexpr int K_THREADS = 256;

__global__ void __launch_bounds__(K_THREADS)
    kmat_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                const float* __restrict__ sigma2, float* __restrict__ out,
                int M, int N, int Q, int vec4) {
  __shared__ __align__(16) float a_s[K_QC][K_BM];
  __shared__ __align__(16) float b_s[K_QC][K_BN];
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int row0 = blockIdx.y * K_BM, col0 = blockIdx.x * K_BN;

  float acc[K_TM][4];
#pragma unroll
  for (int m = 0; m < K_TM; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;

  for (int q0 = 0; q0 < Q; q0 += K_QC) {
    const int qn = min(K_QC, Q - q0);
    if (q0 > 0) __syncthreads();
    for (int e = tid; e < K_BM * qn; e += K_THREADS) {
      const int q = e / K_BM, r = e % K_BM, gr = row0 + r;
      a_s[q][r] = gr < M ? x1[(size_t)gr * Q + q0 + q] : 0.f;
    }
    for (int e = tid; e < K_BN * qn; e += K_THREADS) {
      const int q = e / K_BN, c = e % K_BN, gc = col0 + c;
      b_s[q][c] = gc < N ? x2[(size_t)gc * Q + q0 + q] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < qn; ++q) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[q][ty * K_TM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[q][ty * K_TM + 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&b_s[q][tx * 4]);
      const float a[K_TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int m = 0; m < K_TM; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float d = a[m] - b[n];
          acc[m][n] = fmaf(d, d, acc[m][n]);
        }
    }
  }

  const float s2 = *sigma2;
  const int c = col0 + tx * 4;
#pragma unroll
  for (int m = 0; m < K_TM; ++m) {
    const int r = row0 + ty * K_TM + m;
    if (r >= M) continue;
    float v[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) v[n] = s2 * fast_exp2(-kHalfLog2e * acc[m][n]);
    float* dst = out + (size_t)r * N + c;
    if (vec4) {
      if (c < N)
        __stcs(reinterpret_cast<float4*>(dst),
               make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int n = 0; n < 4; ++n)
        if (c + n < N) __stcs(dst + n, v[n]);
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
// P[i, :] = sum_j Aij xs_j and r[i] = sum_j Aij, for any W.  Replaces
// rbf_nlml_adjoint (edrgp_tpu/ops/pallas/rbf.py:236, pallas_call at :262).
// Its floor on the H100 is reading the N*N*4 bytes of W once (0.080 ms at
// 8192^2 for 3.35 TB/s; K is recomputed per pair and never stored), but at
// Q >= 7 the fp32 instructions bound it: about 3Q+3 per pair (Q subtractions
// and Q FMAs for the distance, a multiply and an exp2, a multiply by W, an
// add for r, Q FMAs for P), 33 at Q=10: more instruction slots than 67
// TFLOP/s suggests, because the subtractions count one flop each.  Design:
//   * a block owns A_BM rows and walks a range of columns in A_BN-wide
//     tiles; each thread owns a 4 x 4 patch of each tile (rows 4ty..,
//     columns 4tx..) and keeps the 4 x QB partial sums of P and the 4 of r
//     in registers, the kernel being specialised on a compile-time QB >= Q
//     (zero-padded coordinates add nothing).  Per tile it forms the 16
//     distances coordinate by coordinate (one float4 of x_i and one of x_j
//     from shared memory per 16 FMA pairs), then the 16 weights, then the
//     P update (one float4 of x_j per 16 FMAs): 16 independent chains;
//   * W and x_j tiles arrive by TMA into a ring of 4 slots: one
//     thread starts two boxes per tile, two tiles ahead, counted on
//     the slot's `full` mbarrier; each warp arrives on the slot's `empty`
//     mbarrier when done with it.  No block-wide barrier in the loop, and no
//     load instructions in the compute warps.  Every W element is read from
//     device memory once; TMA zero-fills past the edges.  Rows of W that are
//     not 16-byte aligned (N % 4 != 0), which TMA cannot describe, are
//     copied by all threads with 4-byte cp.async into the same ring;
//   * N/64 row tiles (128 at N=8192) cannot fill 132 SMs, so blockIdx.y
//     splits the columns into `splits` ranges of `cols_per_split` columns
//     (chosen by the wrapper from N and the SM count for at least two
//     waves); each block writes its rows' partial (P, r) to
//     part[split][row][0..Q], after a shuffle reduction over the 16 threads
//     that share a row, and adjoint_reduce_kernel adds the splits in order
//     and scales by sigma2;
//   * QB is 3, 4, 7, 10 (the EDR's fits) or 16, any other Q up to 16
//     running padded to the next; Q above 16 takes the WIDE instantiation:
//     the distance looped over all Q, and blockIdx.z choosing which 16
//     columns of P the block sums;
//   * no tensor cores: keeping fp32 accuracy on them needs a 3xTF32 split,
//     and the products here are 4 x 4 x Q per thread.
// ---------------------------------------------------------------------------
constexpr int A_BM = 64;        // rows per block: 16 row groups x A_TM
constexpr int A_BN = 64;        // columns per tile: 16 threads x A_TN
constexpr int A_TM = 4;
constexpr int A_TN = 4;
constexpr int A_THREADS = 256;
constexpr int A_WARPS = A_THREADS / 32;
constexpr int A_QMAX = 16;      // largest specialisation of Q
static_assert(A_BM == A_BN, "rbf.adjoint_split plans with one tile size");

// Ring slots; a block runs slots - 2 tiles ahead.  WIDE stages all Q rows of
// x_j per slot, so it keeps one slot fewer and takes Q up to 178.
__host__ __device__ constexpr int adjoint_stages(bool wide) {
  return wide ? 3 : 4;
}

size_t adjoint_smem(int qs, bool wide) {
  return sizeof(float) *
         ((size_t)adjoint_stages(wide) * (A_BM * A_BN + (size_t)qs * A_BN) +
          (size_t)qs * A_BM);
}

template <int QB, bool WIDE, bool TMA>
__global__ void __launch_bounds__(A_THREADS)
    adjoint_kernel(const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap x_map,
                   const float* __restrict__ xsT, int ldx,
                   const float* __restrict__ W, float* __restrict__ part,
                   int N, int Q, int cols_per_split) {
  constexpr int S = adjoint_stages(WIDE);
  extern __shared__ __align__(128) float adj_smem[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const int qs = WIDE ? Q : QB;                 // staged coordinates
  float* w_s = adj_smem;                        // [S][A_BM][A_BN]
  float* xj_s = w_s + S * A_BM * A_BN;          // [S][qs][A_BN]
  float* xi_s = xj_s + S * qs * A_BN;           // [qs][A_BM]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * A_BM;
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(c_begin + cols_per_split, N);
  const int ntiles = c_end > c_begin ? (c_end - c_begin + A_BN - 1) / A_BN : 0;
  const int q0 = WIDE ? blockIdx.z * QB : 0;    // first column of P summed

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], TMA ? 1 : A_THREADS);
      mbar_init(&empty[s], A_WARPS);
    }
    fence_mbar_init();
  }
  // The block's rows x_i, [qs][A_BM], zero past N and past Q.
  for (int e = tid; e < qs * A_BM; e += A_THREADS) {
    const int q = e / A_BM, r = e % A_BM;
    xi_s[e] = (row0 + r < N && q < Q) ? xsT[(size_t)q * ldx + row0 + r] : 0.f;
  }
  __syncthreads();

  // Tile u (columns c_begin + u A_BN ..) into slot u % S, once the
  // tile that held the slot before is consumed; full[slot] completes when
  // its bytes have landed.  W rows 16-byte aligned: two TMA boxes started by
  // one thread.  Otherwise every thread copies 4-byte W elements and
  // 16-byte runs of x_j with cp.async.
  auto fetch = [&](int u) {
    const int s = u % S, c0 = c_begin + u * A_BN;
    float* wb = w_s + s * A_BM * A_BN;
    float* xb = xj_s + s * qs * A_BN;
    if constexpr (TMA) {
      if (tid != 0) return;
      if (u >= S) mbar_wait(&empty[s], (u / S - 1) & 1);
      mbar_expect_tx(&full[s], (int)sizeof(float) * (A_BM + qs) * A_BN);
      tma_load_2d(wb, &w_map, c0, row0, &full[s]);
      tma_load_2d(xb, &x_map, c0, 0, &full[s]);
    } else {
      if (u >= S) mbar_wait(&empty[s], (u / S - 1) & 1);
      for (int e = tid; e < A_BM * A_BN; e += A_THREADS) {
        const int r = e / A_BN, c = e % A_BN;
        const bool live = row0 + r < N && c0 + c < N;
        cp_async4(wb + e, live ? W + (size_t)(row0 + r) * N + c0 + c : W,
                  live);
      }
      for (int e = tid; e < qs * (A_BN / 4); e += A_THREADS) {
        const int q = e / (A_BN / 4), c = 4 * (e % (A_BN / 4));
        const int n = q < Q ? min(max(N - (c0 + c), 0), 4) : 0;
        cp_async16(xb + q * A_BN + c, xsT + (n ? (size_t)q * ldx + c0 + c : 0),
                   4 * n);
      }
      cp_async_arrive(&full[s]);
    }
  };

  float p[A_TM][QB], rs[A_TM];
#pragma unroll
  for (int m = 0; m < A_TM; ++m) {
    rs[m] = 0.f;
#pragma unroll
    for (int q = 0; q < QB; ++q) p[m][q] = 0.f;
  }

  for (int u = 0; u < S - 2 && u < ntiles; ++u) fetch(u);
  for (int t = 0; t < ntiles; ++t) {
    if (t + S - 2 < ntiles) fetch(t + S - 2);
    const int s = t % S;
    mbar_wait(&full[s], (t / S) & 1);

    const float* wb = w_s + s * A_BM * A_BN;
    const float* xb = xj_s + s * qs * A_BN + tx * A_TN;
    // 1. the 4 x 4 squared distances, one coordinate at a time.
    float a[A_TM][A_TN];
#pragma unroll
    for (int m = 0; m < A_TM; ++m)
#pragma unroll
      for (int n = 0; n < A_TN; ++n) a[m][n] = 0.f;
    auto dist = [&](int q) {
      const float4 v = *reinterpret_cast<const float4*>(xb + q * A_BN);
      const float4 u =
          *reinterpret_cast<const float4*>(xi_s + q * A_BM + ty * A_TM);
      const float xj[A_TN] = {v.x, v.y, v.z, v.w};
      const float xr[A_TM] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int m = 0; m < A_TM; ++m)
#pragma unroll
        for (int n = 0; n < A_TN; ++n) {
          const float d = xr[m] - xj[n];
          a[m][n] = fmaf(d, d, a[m][n]);
        }
    };
    // Unrolled by two, not fully: fewer loads run ahead, so fewer registers
    // are live (80 at QB <= 8, three blocks an SM; 128 at QB = 10, two).
    if constexpr (WIDE) {
#pragma unroll 2
      for (int q = 0; q < Q; ++q) dist(q);
    } else {
#pragma unroll 2
      for (int q = 0; q < QB; ++q) dist(q);
    }
    // 2. the weights W_ij k_ij, and their row sums.
#pragma unroll
    for (int m = 0; m < A_TM; ++m) {
      const float4 v = *reinterpret_cast<const float4*>(
          wb + (ty * A_TM + m) * A_BN + tx * A_TN);
      const float w[A_TN] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int n = 0; n < A_TN; ++n) {
        a[m][n] = w[n] * fast_exp2(-kHalfLog2e * a[m][n]);
        rs[m] += a[m][n];
      }
    }
    // 3. P += a x_j, one coordinate at a time.
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      if (WIDE && q0 + q >= Q) break;
      const float4 v =
          *reinterpret_cast<const float4*>(xb + (q0 + q) * A_BN);
      const float xj[A_TN] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int m = 0; m < A_TM; ++m)
#pragma unroll
        for (int n = 0; n < A_TN; ++n) p[m][q] = fmaf(a[m][n], xj[n], p[m][q]);
    }
    __syncwarp();
    if (tid % 32 == 0) mbar_arrive(&empty[s]);
  }

  // Sum each row's partials over the 16 threads (tx) that share it, then
  // spread the stores over those threads.
  float* out = part + (size_t)blockIdx.y * N * (Q + 1);
#pragma unroll
  for (int m = 0; m < A_TM; ++m) {
    const int i = row0 + ty * A_TM + m;
#pragma unroll
    for (int k = 0; k <= QB; ++k) {
      float v = k < QB ? p[m][k] : rs[m];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (i >= N || tx != k % 16) continue;
      if (k < QB) {
        if (q0 + k < Q) out[(size_t)i * (Q + 1) + q0 + k] = v;
      } else if (q0 == 0) {
        out[(size_t)i * (Q + 1) + Q] = v;
      }
    }
  }
}

// P[i, q] = sigma2 * sum_s part[s, i, q], r[i] = sigma2 * sum_s part[s, i, Q]
// with the splits added in order.
__global__ void adjoint_reduce_kernel(const float* __restrict__ part,
                                      const float* __restrict__ sigma2,
                                      float* __restrict__ P,
                                      float* __restrict__ r, int N, int Q,
                                      int splits) {
  const size_t total = (size_t)N * (Q + 1);
  const float s2 = *sigma2;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += part[(size_t)s * total + e];
    const size_t i = e / (Q + 1);
    const int k = (int)(e % (Q + 1));
    if (k < Q)
      P[i * Q + k] = s2 * v;
    else
      r[i] = s2 * v;
  }
}

size_t gradmu_smem(int Q) {
  return sizeof(float) * ((size_t)2 * Q * G_ROWS + (size_t)G_TN * Q + G_TN);
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed;
// cudaErrorInvalidValue when its static and dynamic shared memory together
// exceed what a block may have.  A failed call leaves no error behind for
// the next launch's cudaGetLastError to find.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  int dev = 0, limit = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && bytes + attr.sharedSizeBytes > (size_t)limit)
    return cudaErrorInvalidValue;
  if (err == cudaSuccess && bytes > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// cuTensorMapEncodeTiled, found through the runtime so the library needs
// no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A TMA map of the float32 matrix [rows][ld] (first `cols` columns) that
// loads box_rows x box_cols boxes, zero-filled outside the matrix.
cudaError_t tensor_map(CUtensorMap* map, const float* base, int rows,
                       int cols, int ld, int box_rows, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int QB, bool WIDE, bool TMA>
cudaError_t launch_adjoint_as(const float* xsT, int ldx, const float* W,
                              float* part, int N, int Q, int splits,
                              int cols_per_split, cudaStream_t stream) {
  const int qs = WIDE ? Q : QB;
  CUtensorMap w_map = {}, x_map = {};
  cudaError_t err;
  if constexpr (TMA) {
    err = tensor_map(&w_map, W, N, N, N, A_BM, A_BN);
    if (err != cudaSuccess) return err;
    err = tensor_map(&x_map, xsT, Q, N, ldx, qs, A_BN);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = adjoint_smem(qs, WIDE);
  err = allow_smem(adjoint_kernel<QB, WIDE, TMA>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + A_BM - 1) / A_BM, splits,
                  WIDE ? (Q + QB - 1) / QB : 1);
  adjoint_kernel<QB, WIDE, TMA><<<grid, A_THREADS, smem, stream>>>(
      w_map, x_map, xsT, ldx, W, part, N, Q, cols_per_split);
  return cudaGetLastError();
}

// TMA needs 16-byte aligned rows (N % 4 == 0) and at least one coordinate.
template <int QB, bool WIDE>
cudaError_t launch_adjoint(const float* xsT, int ldx, const float* W,
                           float* part, int N, int Q, int splits,
                           int cols_per_split, cudaStream_t stream) {
  if (N % 4 == 0 && Q > 0 && (uintptr_t)W % 16 == 0 &&
      (uintptr_t)xsT % 16 == 0 && ldx % 4 == 0)
    return launch_adjoint_as<QB, WIDE, true>(xsT, ldx, W, part, N, Q, splits,
                                             cols_per_split, stream);
  return launch_adjoint_as<QB, WIDE, false>(xsT, ldx, W, part, N, Q, splits,
                                            cols_per_split, stream);
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
  const dim3 grid((N + K_BN - 1) / K_BN, (M + K_BM - 1) / K_BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int vec4 = N % 4 == 0 && (uintptr_t)out % 16 == 0;
  kmat_kernel<<<grid, K_THREADS, 0, (cudaStream_t)stream>>>(
      x1, x2, sigma2, out, M, N, Q, vec4);
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

// Rows and columns of the adjoint's tile: its column ranges start on
// multiples of it.
int edrgp_rbf_adjoint_tile() { return A_BN; }

// xsT holds the scaled rows transposed, [max(Q, 1)][ldx] with ldx >= N and
// 16-byte aligned rows; part is
// scratch of splits * N * (Q + 1) floats; the column ranges
// [s * cols_per_split, (s + 1) * cols_per_split) must cover [0, N) and
// start on tile boundaries.
int edrgp_rbf_nlml_adjoint(const float* xsT, int ldx, const float* W,
                           const float* sigma2, float* P, float* r,
                           float* part, int N, int Q, int splits,
                           int cols_per_split, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (Q < 0 || ldx < N || splits < 1 || splits > 65535 || cols_per_split <= 0 ||
      cols_per_split % A_BN != 0 || (long long)splits * cols_per_split < N)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
#define EDRGP_ADJ(QB, WIDE) \
  launch_adjoint<QB, WIDE>(xsT, ldx, W, part, N, Q, splits, cols_per_split, st)
  // Other Q pad up to the next specialisation: zero coordinates add nothing.
  if (Q <= 3)
    err = EDRGP_ADJ(3, false);
  else if (Q == 4)
    err = EDRGP_ADJ(4, false);
  else if (Q <= 7)
    err = EDRGP_ADJ(7, false);
  else if (Q <= 10)
    err = EDRGP_ADJ(10, false);
  else if (Q <= A_QMAX)
    err = EDRGP_ADJ(A_QMAX, false);
  else
    err = EDRGP_ADJ(A_QMAX, true);
#undef EDRGP_ADJ
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)N * (Q + 1);
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                      : 4096);
  adjoint_reduce_kernel<<<blocks, 256, 0, st>>>(part, sigma2, P, r, N, Q,
                                                splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
