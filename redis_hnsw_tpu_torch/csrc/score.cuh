// The score routine of count_gt_eq.cu (kernel B); kernels A (scan_topk.cu)
// and D (select_bins.cu) reproduce its chain in their own 128 x 128 cores.
//
// The certified-exact scan selects with scan_topk and proves its selection
// with count_gt_eq, which counts rows scoring above and at each query's
// k-th selected score; the one-pass form selects and proves with
// select_bins alone, and must rank rows as scan_topk does. Those proofs
// are sound only if the kernels compute BIT-IDENTICAL scores. So kernel B
// computes them here, kernels A and D by the same per-output chain, and
// every score is
//
//   dot   = fma chain over d = 0 .. D-1 in order, starting from +0:
//           dot = __fmaf_rn(q[d], x[d], dot)
//   score = __fsub_rn(__fsub_rn(__fmul_rn(2, dot), qq), sq)
//
// The explicit round-to-nearest intrinsics keep nvcc from contracting
// 2*dot - qq into an FMA in one kernel and not in the other (--fmad=true
// is the default). qq (query sqnorm) and sq (row sqnorm, +inf on a dead
// row, which scores -inf) come from the caller and are never recomputed
// here. True fp32 throughout: no tensor cores, no TF32.
//
// The value of a score depends only on its own query and row, never on
// the tiling, the block or the split: a tile's extra dims beyond D are
// zero, and fma(0, 0, dot) == dot for every dot this chain can produce
// (it never holds -0). So the kernels may tile and split as they like.
//
// Tiling: a block of SCORE_THREADS = 256 threads scores a TILE_Q x TILE_R
// tile (64 queries x 64 rows) as a 16 x 16 grid of 4 x 4 register
// micro-tiles, staging TILE_D = 32 dims of both operands at a time in
// shared memory. The H100 bound of this work is its fp32 FMA rate
// (2*B*N*D operations against B*D + N*D floats read); the register tile
// gives 16 FMAs per two 16-byte shared-memory loads.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace rht {

constexpr int TILE_Q = 64;
constexpr int TILE_R = 64;
constexpr int TILE_D = 32;
constexpr int MICRO = 4;
constexpr int SCORE_THREADS = 256;
// row stride of a staged operand: +4 floats keeps 16-byte alignment
constexpr int STAGE_LD = TILE_Q + 4;

static_assert(TILE_Q == TILE_R, "one staging layout for both operands");
static_assert((TILE_Q / MICRO) * (TILE_R / MICRO) == SCORE_THREADS,
              "one micro-tile per thread");

struct ScoreStage {
  float q[TILE_D][STAGE_LD];  // [d][query] -- transposed for float4 reads
  float x[TILE_D][STAGE_LD];  // [d][row]
};

// Copy dims [d0, d0 + TILE_D) of TILE_Q consecutive rows of a row-major
// [n, D] matrix, starting at row r0, into dst[d][row] (zero outside).
__device__ __forceinline__ void stage_rows(float (*dst)[STAGE_LD],
                                           const float* __restrict__ src,
                                           int r0, int n, int D, int d0) {
  for (int e = threadIdx.x; e < TILE_Q * TILE_D; e += SCORE_THREADS) {
    const int r = e / TILE_D;
    const int d = e % TILE_D;
    float v = 0.f;
    if (r0 + r < n && d0 + d < D) {
      v = src[(size_t)(r0 + r) * D + d0 + d];
    }
    dst[d][r] = v;
  }
}

// Scores of this thread's micro-tile: queries q0 + ty*4 + i, rows
// r0 + tx*4 + j (tx = threadIdx.x % 16, ty = threadIdx.x / 16). All
// SCORE_THREADS threads of the block must call it together (it
// synchronises the block). Scores of rows >= N or queries >= B are left
// as computed from zero operands; callers mask them by index.
__device__ __forceinline__ void score_tile(const float* __restrict__ Q,
                                           const float* __restrict__ X,
                                           const float* __restrict__ qq,
                                           const float* __restrict__ sq,
                                           int B, int N, int D, int q0,
                                           int r0, ScoreStage& st,
                                           float (&s)[MICRO][MICRO]) {
  const int tx = threadIdx.x % (TILE_R / MICRO);
  const int ty = threadIdx.x / (TILE_R / MICRO);
  float dot[MICRO][MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i)
#pragma unroll
    for (int j = 0; j < MICRO; ++j) dot[i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += TILE_D) {
    __syncthreads();  // the previous step's readers are done
    stage_rows(st.q, Q, q0, B, D, d0);
    stage_rows(st.x, X, r0, N, D, d0);
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < TILE_D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&st.q[d][ty * MICRO]);
      const float4 b = *reinterpret_cast<const float4*>(&st.x[d][tx * MICRO]);
      const float av[MICRO] = {a.x, a.y, a.z, a.w};
      const float bv[MICRO] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < MICRO; ++i)
#pragma unroll
        for (int j = 0; j < MICRO; ++j)
          dot[i][j] = __fmaf_rn(av[i], bv[j], dot[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int qi = q0 + ty * MICRO + i;
    const float qn = qi < B ? qq[qi] : 0.f;
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int ri = r0 + tx * MICRO + j;
      const float sn = ri < N ? sq[ri] : CUDART_INF_F;
      s[i][j] = __fsub_rn(__fsub_rn(__fmul_rn(2.f, dot[i][j]), qn), sn);
    }
  }
}

}  // namespace rht
