// The fp32 scoring core of kernels A (scan_topk.cu), B (count_gt_eq.cu)
// and D (select_bins.cu): one 128-query x 128-row block tile, its operand
// ring and the score chain. Kernel A′ takes only the cp.async helpers.
//
// The certified-exact scan selects with kernel A and proves its selection
// with kernel B, which counts rows scoring above and at each query's k-th
// selected score; the one-pass form selects and proves with kernel D
// alone and must rank rows as kernel A does. Those proofs are sound only
// if the three kernels compute BIT-IDENTICAL scores, so they all score
// here, and every score is
//
//   dot   = fma chain over d = 0 .. D-1 in order, starting from +0:
//           dot = __fmaf_rn(q[d], x[d], dot)                 (fma_chunk)
//   score = __fsub_rn(__fsub_rn(__fmul_rn(2, dot), qq), sq)  (l2_score)
//
// The explicit round-to-nearest intrinsics keep nvcc from contracting
// 2*dot - qq into an FMA in one kernel and not in another (--fmad=true is
// the default). qq (query sqnorm) and sq (row sqnorm, +inf on a dead row,
// which scores -inf) come from the caller and are never recomputed here.
// True fp32 throughout: no tensor cores, no TF32, no split-K, no
// reassociation. Dims past D are staged as zeros, and fma(0, 0, dot) ==
// dot for every dot this chain can produce (it never holds -0), so the
// value of a score depends only on its own query and row, never on the
// tiling, the block or the split.
//
// Bound on the H100: 2*B*N*D fp32 operations against (B + N)*D*4 bytes,
// compute-bound at every serving shape (7.8 ms at B = 2048, N = 1M, D =
// 128). So the core aims at the fp32 FMA pipes:
//
// * A block of THREADS = 128 threads scores a TILE_Q x TILE_R tile; each
//   thread holds an MQ x MR = 8 x 16 register tile, queries ty + 16i and
//   rows tx + 8j (tx = tid % 8, ty = tid / 8). Per 4 dims a thread loads
//   its 8 queries' 4 dims (8 16-byte shared-memory loads), then streams
//   its 16 rows, 32 FMAs per 16-byte load. A warp's row loads touch 8
//   rows and its query loads 4 queries, so every load is a broadcast of
//   at most 128 bytes. The 8 lanes that share a query are lanes 8(ty %
//   4) .. + 7 of one warp. (An 8 x 8 tile with 256 threads ran over 15%
//   slower on the H100 and spills at 128 registers a thread;
//   tools/select_bins_study.cu times the variants.)
// * Operands stream through a STAGES-deep ring of K_CHUNK-dim chunks of
//   both tiles in dynamic shared memory, filled by cp.async (16-byte
//   copies; a 4-byte-copy instance when D % 4 != 0 or an operand is not
//   16-byte aligned), one barrier per chunk. A stage holds the query rows
//   then the table rows as they lie in device memory ([row][d], stride
//   LD = K_CHUNK + 4 floats: 8 consecutive rows hit 32 distinct banks).
//   The kernels run the ring on across row tiles, so the next tile's
//   first chunks load during this tile's last ones and its epilogue.

#pragma once

#include <cuda_runtime.h>

namespace rht_l2 {

constexpr int TILE_Q = 128;   // queries per block tile
constexpr int TILE_R = 128;   // rows per block tile
constexpr int THREADS = 128;
constexpr int TQ = 16;        // threads along the queries of a tile
constexpr int TR = 8;         // threads along its rows (lanes of a warp)
constexpr int MQ = 8;         // register tile: MQ queries x MR rows
constexpr int MR = 16;
constexpr int K_CHUNK = 32;   // dims per pipeline stage
constexpr int LD = K_CHUNK + 4;
constexpr int STAGES = 3;
constexpr int STAGE_ROWS = TILE_Q + TILE_R;
constexpr int STAGE_FLOATS = STAGE_ROWS * LD;
constexpr unsigned FULL_MASK = 0xffffffffu;

static_assert(TQ * MQ == TILE_Q && TR * MR == TILE_R, "tile");
static_assert(TQ * TR == THREADS, "one register tile per thread");
static_assert(THREADS == TILE_Q && THREADS == TILE_R, "one norm per thread");

// cp.async of VEC floats; src_bytes < 4 * VEC zero-fills the rest.
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Start copying dims [d0, d0 + K_CHUNK) of query rows q0.. (stage rows
// 0..127) and table rows r0.. (stage rows 128..255) into one stage;
// zeros past B, N and D. VEC = 4 needs D % 4 == 0 and aligned operands,
// so a 16-byte copy is wholly inside or wholly outside D.
template <int VEC>
__device__ __forceinline__ void load_chunk(float* stage,
                                           const float* __restrict__ Q,
                                           const float* __restrict__ X,
                                           int B, int N, int D, int q0,
                                           int r0, int d0) {
  constexpr int PER_ROW = K_CHUNK / VEC;
  constexpr int ROWS_PER_PASS = THREADS / PER_ROW;
  const int col = threadIdx.x % PER_ROW;
  const int d = d0 + col * VEC;
#pragma unroll
  for (int p = 0; p < STAGE_ROWS / ROWS_PER_PASS; ++p) {
    const int r = threadIdx.x / PER_ROW + p * ROWS_PER_PASS;
    const bool is_q = p < TILE_Q / ROWS_PER_PASS;  // r < TILE_Q
    const int g = is_q ? q0 + r : r0 + r - TILE_Q;
    const float* base = is_q ? Q : X;
    const bool ok = g < (is_q ? B : N) && d < D;
    cp_async<VEC>(stage + r * LD + col * VEC,
                  ok ? base + (size_t)g * D + d : base, ok ? 4 * VEC : 0);
  }
}

// acc[i][j] += the chunk's products of query ty + 16i and row tx + 8j,
// one FMA per dim in ascending order.
__device__ __forceinline__ void fma_chunk(const float* stage, int tx, int ty,
                                          float (&acc)[MQ][MR]) {
  const float* qs = stage + ty * LD;
  const float* xs = stage + (TILE_Q + tx) * LD;
  // unrolled by 2, not 8: fully unrolled, ptxas hoists loads until the
  // 16-byte form spills at 255 registers
#pragma unroll 2
  for (int k = 0; k < K_CHUNK; k += 4) {
    float qf[MQ][4];
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(qs + i * TQ * LD + k);
      qf[i][0] = v.x;
      qf[i][1] = v.y;
      qf[i][2] = v.z;
      qf[i][3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < MR; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(xs + j * TR * LD + k);
      const float xf[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int i = 0; i < MQ; ++i)
          acc[i][j] = __fmaf_rn(qf[i][c], xf[c], acc[i][j]);
    }
  }
}

// The score of a finished dot product: (2 dot - qq) - sq, each step
// rounded on its own.
__device__ __forceinline__ float l2_score(float dot, float qn, float sn) {
  return __fsub_rn(__fsub_rn(__fmul_rn(2.f, dot), qn), sn);
}

}  // namespace rht_l2
