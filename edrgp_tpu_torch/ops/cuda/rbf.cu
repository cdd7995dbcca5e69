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
//     cannot fill the card (A, G), the columns are split over blocks and the
//     per-split partial sums are added in a fixed order by a second kernel:
//     no atomics, so two launches on the same inputs agree bit for bit;
//   * ragged edges are masked (or zero-filled by TMA), not padded;
//   * no tensor cores: Q is rarely a multiple of 8, and fp32 accuracy on
//     them would need a 3xTF32 split (see the contraction below).
// Any Q works as long as the shared-memory tiles fit; a launch whose tiles
// do not fit is refused with cudaErrorInvalidValue.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
// The contraction shared by A and G.  With rows x_i (i < M) and columns x_j
// (j < N) in scaled coordinates and a weight w_ij,
//   a_ij = w_ij exp(-0.5 ||x_i - x_j||^2),
//   P[i, :] = sum_j a_ij x_j,   r[i] = sum_j a_ij,
// the constant sigma2 applied afterwards.  A takes rows = columns = X / l and
// streams w_ij = W[i, j] (HAS_W); G takes rows Xnew / l, columns X / l and
// w_ij = alpha_j.  A pair costs A about 3Q+3 fp32 instructions (Q
// subtractions and Q FMAs for the distance, a multiply and an exp2, the
// weight, an add for r, Q FMAs for P), so past a few Q the instruction issue
// bounds the loop.  G, which streams no W, forms the distance as
// |x_i|^2 + |x_j|^2 - 2 x_i.x_j instead (the TPU kernel's form), from norms
// staged with its inputs: 2Q+5 a pair.  Design:
//   * a block owns C_BM rows and walks a range of columns in C_BN-wide
//     tiles; each thread owns a 4 x 4 patch of each tile (rows 4ty..,
//     columns 4tx..) and keeps the 4 x QB partial sums of P and the 4 of r
//     in registers, the kernel being specialised on a compile-time QB >= Q
//     (zero-padded coordinates add nothing).  Per tile it forms the 16
//     distances (or dot products) coordinate by coordinate (one float4 of
//     x_i and one of x_j from shared memory per 16 pairs), then the 16
//     weights, then the P update (one float4 of x_j per 16 FMAs): 16
//     independent chains;
//   * x_j tiles (and for A the W tiles) arrive by TMA into a ring of
//     shared-memory slots: one thread starts the boxes of a tile ahead of
//     use, counted on the slot's `full` mbarrier; each warp arrives on the
//     slot's `empty` mbarrier when done with it.  No block-wide barrier in
//     the loop, and no load instructions for the tiles in the compute warps.
//     TMA zero-fills past the edges.  Where TMA cannot describe the tiles
//     (A's W rows when N % 4 != 0, more than 256 staged coordinates), all
//     threads copy them with cp.async into the same ring.  G's weights and
//     column norms are one float4 each per thread and tile, read through
//     the L1;
//   * where the row tiles cannot fill the card (M/64 = 128 at M = 8192 on
//     132 SMs), blockIdx.y splits the columns into `splits` ranges of
//     `cols_per_split` columns (rbf.column_split plans them from M, N and
//     a number of blocks per SM); each block writes its rows'
//     partial (P, r) to part[split][row][0..Q], after a shuffle reduction
//     over the 16 threads that share a row, and a second kernel adds the
//     splits in order: no atomics, so two launches agree bit for bit;
//   * QB is 3, 4, 7, 10 (the EDR's fits) or 16, any other Q up to 16
//     running padded to the next; Q above 16 takes the WIDE instantiation:
//     the distance looped over all Q, and blockIdx.z choosing which 16
//     columns of P the block sums;
//   * no tensor cores: keeping fp32 accuracy on them needs a 3xTF32 split,
//     and the products here are 4 x 4 x Q per thread.
// ---------------------------------------------------------------------------
constexpr int C_BM = 64;        // rows per block: 16 row groups x C_TM
constexpr int C_BN = 64;        // columns per tile: 16 threads x C_TN
constexpr int C_TM = 4;
constexpr int C_TN = 4;
constexpr int C_THREADS = 256;
constexpr int C_WARPS = C_THREADS / 32;
constexpr int C_QMAX = 16;      // largest specialisation of Q
constexpr int TMA_BOX_MAX = 256;  // longest side of a TMA box
static_assert(C_BM == C_BN, "rbf.column_split plans with one tile size");

// Ring slots.  WIDE stages all Q rows of x_j per slot, so it keeps fewer:
// 3 beside A's W tiles (Q up to 178), 2 for G (Q up to 302).
__host__ __device__ constexpr int ring_stages(bool wide, bool has_w) {
  return !wide ? 4 : has_w ? 3 : 2;
}

// Tiles a block loads ahead of the one it computes.  Two slots stay free, so
// the loading thread seldom waits for the slowest warp; a 2-slot ring keeps
// one.
__host__ __device__ constexpr int ring_ahead(int stages) {
  return stages > 2 ? stages - 2 : 1;
}

size_t contract_smem(int qs, bool wide, bool has_w) {
  const size_t w = has_w ? (size_t)C_BM * C_BN : 0;
  return sizeof(float) *
         ((size_t)ring_stages(wide, has_w) * (w + (size_t)qs * C_BN) +
          (size_t)qs * C_BM);
}

// xrT and xcT hold the scaled rows and columns transposed, [Q][ldr] and
// [Q][ldc] with 16-byte aligned rows; wgt is W [M][N] (HAS_W) or, for G,
// [2][ldc]: alpha, then -log2(e)/2 |x_j|^2, both zero past N.
template <int QB, bool WIDE, bool TMA, bool HAS_W>
__global__ void __launch_bounds__(C_THREADS)
    contract_kernel(const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap x_map,
                    const float* __restrict__ xrT, int ldr,
                    const float* __restrict__ xcT, int ldc,
                    const float* __restrict__ wgt, float* __restrict__ part,
                    int M, int N, int Q, int cols_per_split) {
  constexpr int S = ring_stages(WIDE, HAS_W);
  constexpr int AHEAD = ring_ahead(S);
  constexpr int WT = HAS_W ? C_BM * C_BN : 0;   // W floats per slot
  extern __shared__ __align__(128) float c_smem[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const int qs = WIDE ? Q : QB;                 // staged coordinates
  float* w_s = c_smem;                          // [S][C_BM][C_BN], A only
  float* xj_s = w_s + S * WT;                   // [S][qs][C_BN]
  float* xi_s = xj_s + S * qs * C_BN;           // [qs][C_BM]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * C_BM;
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(c_begin + cols_per_split, N);
  const int ntiles = c_end > c_begin ? (c_end - c_begin + C_BN - 1) / C_BN : 0;
  const int q0 = WIDE ? blockIdx.z * QB : 0;    // first column of P summed

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], TMA ? 1 : C_THREADS);
      mbar_init(&empty[s], C_WARPS);
    }
    fence_mbar_init();
  }
  // The block's rows x_i, [qs][C_BM], zero past M and past Q.
  for (int e = tid; e < qs * C_BM; e += C_THREADS) {
    const int q = e / C_BM, r = e % C_BM;
    xi_s[e] = (row0 + r < M && q < Q) ? xrT[(size_t)q * ldr + row0 + r] : 0.f;
  }
  __syncthreads();
  // G: -log2(e)/2 |x_i|^2 of the thread's 4 rows.
  float ni[C_TM] = {};
  if constexpr (!HAS_W) {
#pragma unroll
    for (int m = 0; m < C_TM; ++m) {
      for (int q = 0; q < qs; ++q) {
        const float v = xi_s[q * C_BM + ty * C_TM + m];
        ni[m] = fmaf(v, v, ni[m]);
      }
      ni[m] *= -kHalfLog2e;
    }
  }

  // Tile u (columns c_begin + u C_BN ..) into slot u % S, once the tile
  // that held the slot before is consumed; full[slot] completes when its
  // bytes have landed.  TMA: the boxes started by one thread.  Otherwise
  // every thread copies 4-byte W elements and 16-byte runs of x_j with
  // cp.async.
  auto fetch = [&](int u) {
    const int s = u % S, c0 = c_begin + u * C_BN;
    float* wb = w_s + s * WT;
    float* xb = xj_s + s * qs * C_BN;
    if constexpr (TMA) {
      if (tid != 0) return;
      if (u >= S) mbar_wait(&empty[s], (u / S - 1) & 1);
      mbar_expect_tx(&full[s],
                     (int)sizeof(float) * (WT / C_BN + qs) * C_BN);
      if constexpr (HAS_W) tma_load_2d(wb, &w_map, c0, row0, &full[s]);
      tma_load_2d(xb, &x_map, c0, 0, &full[s]);
    } else {
      if (u >= S) mbar_wait(&empty[s], (u / S - 1) & 1);
      if constexpr (HAS_W) {
        for (int e = tid; e < C_BM * C_BN; e += C_THREADS) {
          const int r = e / C_BN, c = e % C_BN;
          const bool live = row0 + r < M && c0 + c < N;
          cp_async4(wb + e, live ? wgt + (size_t)(row0 + r) * N + c0 + c : wgt,
                    live);
        }
      }
      for (int e = tid; e < qs * (C_BN / 4); e += C_THREADS) {
        const int q = e / (C_BN / 4), c = 4 * (e % (C_BN / 4));
        const int n = q < Q ? min(max(N - (c0 + c), 0), 4) : 0;
        cp_async16(xb + q * C_BN + c, xcT + (n ? (size_t)q * ldc + c0 + c : 0),
                   4 * n);
      }
      cp_async_arrive(&full[s]);
    }
  };

  float p[C_TM][QB], rs[C_TM];
#pragma unroll
  for (int m = 0; m < C_TM; ++m) {
    rs[m] = 0.f;
#pragma unroll
    for (int q = 0; q < QB; ++q) p[m][q] = 0.f;
  }

  for (int u = 0; u < AHEAD && u < ntiles; ++u) fetch(u);
  for (int t = 0; t < ntiles; ++t) {
    if (t + AHEAD < ntiles) fetch(t + AHEAD);
    const int s = t % S;
    // G: alpha and the norms of the thread's 4 columns, loaded before the
    // wait.
    float4 al = make_float4(0.f, 0.f, 0.f, 0.f), nj = al;
    if constexpr (!HAS_W) {
      const int c = c_begin + t * C_BN + tx * C_TN;
      if (c < N) {
        al = __ldg(reinterpret_cast<const float4*>(wgt + c));
        nj = __ldg(reinterpret_cast<const float4*>(wgt + ldc + c));
      }
    }
    mbar_wait(&full[s], (t / S) & 1);

    const float* wb = w_s + s * WT;
    const float* xb = xj_s + s * qs * C_BN + tx * C_TN;
    // 1. the 4 x 4 squared distances (G: dot products), one coordinate at a
    // time.
    float a[C_TM][C_TN];
#pragma unroll
    for (int m = 0; m < C_TM; ++m)
#pragma unroll
      for (int n = 0; n < C_TN; ++n) a[m][n] = 0.f;
    auto dist = [&](int q) {
      const float4 v = *reinterpret_cast<const float4*>(xb + q * C_BN);
      const float4 u =
          *reinterpret_cast<const float4*>(xi_s + q * C_BM + ty * C_TM);
      const float xj[C_TN] = {v.x, v.y, v.z, v.w};
      const float xr[C_TM] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int m = 0; m < C_TM; ++m)
#pragma unroll
        for (int n = 0; n < C_TN; ++n) {
          if constexpr (HAS_W) {
            const float d = xr[m] - xj[n];
            a[m][n] = fmaf(d, d, a[m][n]);
          } else {
            a[m][n] = fmaf(xr[m], xj[n], a[m][n]);
          }
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
    // 2. the weights w_ij k_ij, and their row sums.
#pragma unroll
    for (int m = 0; m < C_TM; ++m) {
      const float4 v =
          HAS_W ? *reinterpret_cast<const float4*>(
                      wb + (ty * C_TM + m) * C_BN + tx * C_TN)
                : al;
      const float w[C_TN] = {v.x, v.y, v.z, v.w};
      const float nn[C_TN] = {nj.x, nj.y, nj.z, nj.w};
#pragma unroll
      for (int n = 0; n < C_TN; ++n) {
        const float e = HAS_W ? -kHalfLog2e * a[m][n]
                              : fmaf(2.f * kHalfLog2e, a[m][n], ni[m] + nn[n]);
        a[m][n] = w[n] * fast_exp2(e);
        rs[m] += a[m][n];
      }
    }
    // 3. P += a x_j, one coordinate at a time.
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      if (WIDE && q0 + q >= Q) break;
      const float4 v =
          *reinterpret_cast<const float4*>(xb + (q0 + q) * C_BN);
      const float xj[C_TN] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int m = 0; m < C_TM; ++m)
#pragma unroll
        for (int n = 0; n < C_TN; ++n) p[m][q] = fmaf(a[m][n], xj[n], p[m][q]);
    }
    __syncwarp();
    if (tid % 32 == 0) mbar_arrive(&empty[s]);
  }

  // Sum each row's partials over the 16 threads (tx) that share it, then
  // spread the stores over those threads.
  float* out = part + (size_t)blockIdx.y * M * (Q + 1);
#pragma unroll
  for (int m = 0; m < C_TM; ++m) {
    const int i = row0 + ty * C_TM + m;
#pragma unroll
    for (int k = 0; k <= QB; ++k) {
      float v = k < QB ? p[m][k] : rs[m];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (i >= M || tx != k % 16) continue;
      if (k < QB) {
        if (q0 + k < Q) out[(size_t)i * (Q + 1) + q0 + k] = v;
      } else if (q0 == 0) {
        out[(size_t)i * (Q + 1) + Q] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// A: with Aij = W[i, j] * sigma2 * exp(-0.5 ||xs_i - xs_j||^2),
// P[i, :] = sum_j Aij xs_j and r[i] = sum_j Aij, for any W.  Replaces
// rbf_nlml_adjoint (edrgp_tpu/ops/pallas/rbf.py:236, pallas_call at :262).
// Its floor on the H100 is reading the N*N*4 bytes of W once (0.080 ms at
// 8192^2 for 3.35 TB/s; K is recomputed per pair and never stored), but at
// Q >= 7 the contraction's fp32 instructions bound it: 33 a pair at Q=10,
// more instruction slots than 67 TFLOP/s suggests, because the subtractions
// count one flop each.  It is the contraction with W streamed through the
// ring beside x_j; its second pass scales the ordered sum of the splits by
// sigma2.
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// G: out[m, :] = sigma2 sum_i alpha_i k(xs_m, xs_i) (xs_i - xs_m) / l, the
// gradient of the posterior mean at the M test rows.  Replaces rbf_grad_mu
// (edrgp_tpu/ops/pallas/rbf.py:149, pallas_call at :172) in its own form:
// (P[m] - xs_m r[m]) / l from the contraction with rows Xnew / l, columns
// X / l and w_mi = alpha_i, the distances from norms and dot products as
// the TPU kernel forms them.  Its floor on the H100 is fp32 work, (4Q+5)
// flops a pair in that form, 0.045 ms at M = N = 8192, Q = 10 for 67
// TFLOP/s, against (M + N) Q floats of input; the [M, N] weights never
// leave the SM.  So G is the contraction with no W: nothing but x_j in the
// ring, alpha and the column norms read as one float4 each a thread and
// tile, and only 2 ring slots when WIDE, so that Q reaches 302.  The column
// splits go through part[] as for A, planned for one wave of the blocks an
// SM holds at once (a single split once the row tiles fill it), and
// gradmu_finish_kernel adds them in order and forms sigma2 (P - xs r) / l in
// the same pass.  Both the difference and the norms cancel when the data
// sit far from the origin relative to l, so gradmu_stage_kernel centres
// both row sets on the first training row as it scales and transposes them
// (distances do not change): P, xs r and the norms then stay of the size of
// the data's spread.
// ---------------------------------------------------------------------------

// The contraction's inputs for G, one thread per row: xrT[q][i] =
// (Xnew[i][q] - X[0][q]) / l_q for i < M; for j < N, xcT[q][j] =
// (X[j][q] - X[0][q]) / l_q, xcT[Q][j] = alpha_j and xcT[Q + 1][j] =
// -log2(e)/2 sum_q xcT[q][j]^2; zero for N <= j < ldc.
__global__ void gradmu_stage_kernel(const float* __restrict__ Xnew,
                                    const float* __restrict__ X,
                                    const float* __restrict__ alpha,
                                    const float* __restrict__ ls,
                                    float* __restrict__ xrT, int ldr,
                                    float* __restrict__ xcT, int ldc, int M,
                                    int N, int Q) {
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < (size_t)M + ldc; t += (size_t)gridDim.x * blockDim.x) {
    const bool row = t < (size_t)M;
    const size_t j = row ? t : t - M;
    const bool live = row || j < (size_t)N;
    const float* x = (row ? Xnew : X) + j * Q;
    float* out = row ? xrT + j : xcT + j;
    const int ld = row ? ldr : ldc;
    float n2 = 0.f;
    for (int q = 0; q < Q; ++q) {
      const float v = live ? (x[q] - (N ? X[q] : 0.f)) / ls[q] : 0.f;
      out[(size_t)q * ld] = v;
      n2 = fmaf(v, v, n2);
    }
    if (!row) {
      out[(size_t)Q * ld] = live ? alpha[j] : 0.f;
      out[(size_t)(Q + 1) * ld] = -kHalfLog2e * n2;
    }
  }
}

// G[i, q] = sigma2 (sum_s part[s, i, q] - xs[i, q] sum_s part[s, i, Q]) / l_q
// with the splits added in order; xs is read from the rows' buffer xrT.
__global__ void gradmu_finish_kernel(const float* __restrict__ part,
                                     const float* __restrict__ xrT, int ldr,
                                     const float* __restrict__ ls,
                                     const float* __restrict__ sigma2,
                                     float* __restrict__ G, int M, int Q,
                                     int splits) {
  const size_t total = (size_t)M * Q, stride = (size_t)M * (Q + 1);
  const float s2 = *sigma2;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t i = e / Q;
    const int k = (int)(e % Q);
    const float* pi = part + i * (Q + 1);
    float v = 0.f, r = 0.f;
    for (int s = 0; s < splits; ++s) {
      v += pi[s * stride + k];
      r += pi[s * stride + Q];
    }
    G[e] = s2 * (v - xrT[(size_t)k * ldr + i] * r) / ls[k];
  }
}

// Blocks of 256 threads for an elementwise pass over `total` elements.
int pass_blocks(size_t total) {
  return (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
}

// Opt a kernel into more than 48 KB of shared memory (static and dynamic
// together: the default's limit) when needed;
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
  if (err == cudaSuccess && bytes + attr.sharedSizeBytes > 48 * 1024)
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

struct ContractArgs {
  const float* xrT;
  int ldr;
  const float* xcT;
  int ldc;
  const float* wgt;   // W (A) or alpha (G)
  float* part;
  int M, N, Q, splits, cols_per_split;
  cudaStream_t stream;
};

template <int QB, bool WIDE, bool TMA, bool HAS_W>
cudaError_t launch_contract_as(const ContractArgs& a) {
  const int qs = WIDE ? a.Q : QB;
  CUtensorMap w_map = {}, x_map = {};
  cudaError_t err;
  if constexpr (TMA) {
    if constexpr (HAS_W) {
      err = tensor_map(&w_map, a.wgt, a.M, a.N, a.N, C_BM, C_BN);
      if (err != cudaSuccess) return err;
    }
    err = tensor_map(&x_map, a.xcT, a.Q, a.N, a.ldc, qs, C_BN);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = contract_smem(qs, WIDE, HAS_W);
  err = allow_smem(contract_kernel<QB, WIDE, TMA, HAS_W>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.M + C_BM - 1) / C_BM, a.splits,
                  WIDE ? (a.Q + QB - 1) / QB : 1);
  contract_kernel<QB, WIDE, TMA, HAS_W><<<grid, C_THREADS, smem, a.stream>>>(
      w_map, x_map, a.xrT, a.ldr, a.xcT, a.ldc, a.wgt, a.part, a.M, a.N, a.Q,
      a.cols_per_split);
  return cudaGetLastError();
}

// TMA needs at least one column and one coordinate, a box of at most 256
// coordinates and 16-byte aligned rows (for A's W, N % 4 == 0).
template <int QB, bool WIDE, bool HAS_W>
cudaError_t launch_contract_qb(const ContractArgs& a) {
  const int qs = WIDE ? a.Q : QB;
  if (a.N > 0 && a.Q > 0 && qs <= TMA_BOX_MAX && (uintptr_t)a.xcT % 16 == 0 &&
      a.ldc % 4 == 0 &&
      (!HAS_W || (a.N % 4 == 0 && (uintptr_t)a.wgt % 16 == 0)))
    return launch_contract_as<QB, WIDE, true, HAS_W>(a);
  return launch_contract_as<QB, WIDE, false, HAS_W>(a);
}

// f(QB, WIDE), as std::integral_constant and std::bool_constant, for the
// specialisation that serves Q.  Other Q pad up to the next: zero
// coordinates add nothing.
template <typename F>
auto by_q(int Q, F&& f) {
  using std::bool_constant;
  using std::integral_constant;
  if (Q <= 3) return f(integral_constant<int, 3>{}, bool_constant<false>{});
  if (Q == 4) return f(integral_constant<int, 4>{}, bool_constant<false>{});
  if (Q <= 7) return f(integral_constant<int, 7>{}, bool_constant<false>{});
  if (Q <= 10) return f(integral_constant<int, 10>{}, bool_constant<false>{});
  if (Q <= C_QMAX)
    return f(integral_constant<int, C_QMAX>{}, bool_constant<false>{});
  return f(integral_constant<int, C_QMAX>{}, bool_constant<true>{});
}

template <bool HAS_W>
cudaError_t launch_contract(const ContractArgs& a) {
  return by_q(a.Q, [&](auto qb, auto wide) {
    return launch_contract_qb<decltype(qb)::value, decltype(wide)::value,
                              HAS_W>(a);
  });
}

// Blocks of G's contraction (its TMA instantiation) that one SM of the
// current card holds at once at this Q; 0 where none fits.
int gradmu_resident(int Q) {
  return by_q(Q, [&](auto qb, auto wide) {
    constexpr int QB = decltype(qb)::value;
    constexpr bool WIDE = decltype(wide)::value;
    const auto kernel = contract_kernel<QB, WIDE, true, false>;
    const size_t smem = contract_smem(WIDE ? Q : QB, WIDE, false);
    int n = 0;
    if (allow_smem(kernel, smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, C_THREADS,
                                                      smem) != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    return n;
  });
}

// The column ranges [s * cols_per_split, (s + 1) * cols_per_split) must
// cover [0, N) and start on tile boundaries.
bool bad_split(int N, int splits, int cols_per_split) {
  return splits < 1 || splits > 65535 || cols_per_split <= 0 ||
         cols_per_split % C_BN != 0 ||
         (long long)splits * cols_per_split < N;
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

// Rows and columns of the contraction's tile: its column ranges start on
// multiples of it.
int edrgp_rbf_contract_tile() { return C_BN; }

// Blocks of G's contraction an SM holds at once at this Q, for the column
// split's plan.
int edrgp_rbf_grad_mu_resident(int Q) {
  return Q > 0 ? gradmu_resident(Q) : 0;
}

// G [M][Q] from Xnew [M][Q], X [N][Q], alpha [N] and the [Q] lengthscales
// ls.  Scratch: xrT [Q][ldr] and xcT [Q + 2][ldc] (ldr >= M, ldc >= N,
// multiples of 4, 16-byte aligned) and part, splits * M * (Q + 1) floats.
int edrgp_rbf_grad_mu(const float* Xnew, const float* X, const float* alpha,
                      const float* ls, const float* sigma2, float* G,
                      float* xrT, int ldr, float* xcT, int ldc, float* part,
                      int M, int N, int Q, int splits, int cols_per_split,
                      void* stream) {
  if (M <= 0 || Q <= 0) return (int)cudaSuccess;
  if (N < 0 || ldr < M || ldc < N || ldr % 4 || ldc % 4 ||
      bad_split(N, splits, cols_per_split))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  gradmu_stage_kernel<<<pass_blocks((size_t)M + ldc), 256, 0, st>>>(
      Xnew, X, alpha, ls, xrT, ldr, xcT, ldc, M, N, Q);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_contract<false>({xrT, ldr, xcT, ldc, xcT + (size_t)Q * ldc,
                                  part, M, N, Q, splits, cols_per_split, st});
  if (err != cudaSuccess) return (int)err;
  gradmu_finish_kernel<<<pass_blocks((size_t)M * Q), 256, 0, st>>>(
      part, xrT, ldr, ls, sigma2, G, M, Q, splits);
  return (int)cudaGetLastError();
}

// xsT holds the scaled rows transposed, [max(Q, 1)][ldx] with ldx >= N and
// 16-byte aligned rows; part is scratch of splits * N * (Q + 1) floats.
int edrgp_rbf_nlml_adjoint(const float* xsT, int ldx, const float* W,
                           const float* sigma2, float* P, float* r,
                           float* part, int N, int Q, int splits,
                           int cols_per_split, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (Q < 0 || ldx < N || bad_split(N, splits, cols_per_split))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = launch_contract<true>(
      {xsT, ldx, xsT, ldx, W, part, N, N, Q, splits, cols_per_split, st});
  if (err != cudaSuccess) return (int)err;
  adjoint_reduce_kernel<<<pass_blocks((size_t)N * (Q + 1)), 256, 0, st>>>(
      part, sigma2, P, r, N, Q, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
