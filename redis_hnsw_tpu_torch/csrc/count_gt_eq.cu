// Kernel B: per-query counts of rows scoring above and at a threshold.
//
// Replaces redis_hnsw_tpu/ops/pallas_count.py::count_gt_eq (the
// pl.pallas_call at :103, _count_kernel :54): the certificate's second
// pass. For each query b it counts the rows whose score (csrc/score.cuh,
// the SAME routine scan_topk.cu selects with, so the scores are
// bit-identical) is > t[b] and == t[b]. Dead rows carry sq = +inf and
// score -inf, so they count only against t = -inf, where the
// certificate ignores the tie count.
//
// The Pallas kernel accumulates the counts across its sequential row
// grid. Here block (query tile, split) counts its 64 queries over one
// contiguous range of rows in registers, reduces over the 16 threads that
// share a query with warp shuffles, and adds the totals into c_gt / c_eq
// with integer atomics: exact, whatever the order.
//
// Bound on the H100: 2*B*N*D fp32 operations against (B + N)*D*4 bytes
// read -- compute-bound like the selection, with a cheaper epilogue (two
// compares per score, no list). Not tuned.
//
// C interface (ctypes, ops/cuda_count.py): c_gt and c_eq must be zeroed
// by the caller; returns cudaGetLastError().

#include "score.cuh"

namespace rht {

__global__ void __launch_bounds__(SCORE_THREADS)
    count_kernel(const float* __restrict__ Q, const float* __restrict__ X,
                 const float* __restrict__ qq, const float* __restrict__ sq,
                 const float* __restrict__ t, int B, int N, int D,
                 int rows_per_split, int* __restrict__ c_gt,
                 int* __restrict__ c_eq) {
  __shared__ __align__(16) ScoreStage st;
  const int q0 = blockIdx.x * TILE_Q;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);
  const int tx = threadIdx.x % (TILE_R / MICRO);
  const int ty = threadIdx.x / (TILE_R / MICRO);

  float th[MICRO];
  int gt[MICRO];
  int eq[MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int qi = q0 + ty * MICRO + i;
    th[i] = qi < B ? t[qi] : 0.f;
    gt[i] = 0;
    eq[i] = 0;
  }

  for (int r0 = r_begin; r0 < r_end; r0 += TILE_R) {
    float s[MICRO][MICRO];
    score_tile(Q, X, qq, sq, B, N, D, q0, r0, st, s);
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      if (r0 + tx * MICRO + j < r_end) {
#pragma unroll
        for (int i = 0; i < MICRO; ++i) {
          gt[i] += s[i][j] > th[i];
          eq[i] += s[i][j] == th[i];
        }
      }
    }
  }

  // the 16 threads of one query group are lanes tx = 0..15 of one
  // half-warp (threadIdx.x = ty * 16 + tx)
#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      gt[i] += __shfl_xor_sync(0xffffffffu, gt[i], off);
      eq[i] += __shfl_xor_sync(0xffffffffu, eq[i], off);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const int qi = q0 + ty * MICRO + i;
      if (qi < B) {
        if (gt[i]) atomicAdd(&c_gt[qi], gt[i]);
        if (eq[i]) atomicAdd(&c_eq[qi], eq[i]);
      }
    }
  }
}

}  // namespace rht

extern "C" int count_gt_eq_launch(const float* q, const float* x,
                                  const float* qq, const float* sq,
                                  const float* t, int B, int N, int D,
                                  int splits, int* c_gt, int* c_eq,
                                  cudaStream_t stream) {
  using namespace rht;
  if (B <= 0 || N <= 0) return 0;
  if (splits < 1 || splits > 65535) return (int)cudaErrorInvalidValue;
  const int tiles = (N + TILE_R - 1) / TILE_R;
  const int rows_per_split = ((tiles + splits - 1) / splits) * TILE_R;
  const dim3 grid((B + TILE_Q - 1) / TILE_Q, splits);
  count_kernel<<<grid, SCORE_THREADS, 0, stream>>>(
      q, x, qq, sq, t, B, N, D, rows_per_split, c_gt, c_eq);
  return (int)cudaGetLastError();
}
