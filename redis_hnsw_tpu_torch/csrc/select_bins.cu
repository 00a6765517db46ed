// Kernel D: the one-pass certified select -- per-bin best rows and the
// global second-best bound.
//
// Replaces redis_hnsw_tpu/ops/pallas_select.py::select_bins (the
// pl.pallas_call at :189, _select_kernel :129, _bin_reduce :110). The rows
// are cut into bins of BIN_L = 128 consecutive rows. Per query b and bin j
// it emits
//
//   sims[b, j] = max1, the bin's best score;
//   ids[b, j]  = the row id of max1 (the lowest id on ties);
//
// and per query
//
//   m2[b] = the max over all bins of the bin's best score with that ONE
//           element removed (a duplicate of max1 at another row counts).
//
// Every row outside the candidate set scores <= m2, so a stable top-k over
// the candidates whose k-th score t exceeds m2 is the exact top-k of the
// whole table (ops/scan.py _certified_onepass). That argument ranks the
// candidates by kernel A's own scores: both kernels score through
// rht::score_tile (score.cuh), the same 64 x 64 tiles and K-loop, so
// D's best candidate of a query is kernel A's top-1, bit for bit.
//
// The Pallas kernel carries m2 and rolls bin blocks across a sequential
// row grid. Here a bin is two of score.cuh's 64-row tiles: block (query
// tile, split) walks its contiguous range of bins; per tile each thread
// reduces its 4 rows per query, 16 threads (a half-warp) combine theirs
// with shuffles, and the two tiles of a bin combine in registers. A bin's
// (max1, id) goes straight to its output column. m2 is reduced across
// blocks, which run in no order, in a second pass: each block writes one
// partial per query and split, and m2_reduce_kernel takes their max.
//
// Bound on the H100: 2*B*N*D fp32 operations against (B + N)*D*4 bytes
// read plus the B*N/128*8 bytes of bins written -- compute-bound like
// kernel B, whose scoring it repeats with a per-bin reduction in place of
// the counts. Not tuned.
//
// C interface (ctypes, ops/cuda_select.py): returns cudaGetLastError().

#include "score.cuh"

namespace rht {

constexpr int BIN_L = 2 * TILE_R;
constexpr unsigned FULL_MASK = 0xffffffffu;

// Fold the reduction (o1, oi, o2) of a disjoint set of rows of the same
// bin into (m1, i1, m2): the winner is the higher score, then the lower
// in-bin index; the loser's best becomes a second-best candidate.
__device__ __forceinline__ void bin_fold(float& m1, int& i1, float& m2,
                                         float o1, int oi, float o2) {
  if (o1 > m1 || (o1 == m1 && oi < i1)) {
    m2 = o2 > m1 ? o2 : m1;
    m1 = o1;
    i1 = oi;
  } else if (o1 > m2) {
    m2 = o1;
  }
}

__global__ void __launch_bounds__(SCORE_THREADS)
    select_bins_kernel(const EuclidScorer score, int nbins,
                       int bins_per_split, float* __restrict__ sims,
                       int* __restrict__ ids,
                       float* __restrict__ m2_part) {
  __shared__ __align__(16) ScoreStage st;
  const int B = score.B;
  const int q0 = blockIdx.x * TILE_Q;
  const int split = blockIdx.y;
  const int b_begin = split * bins_per_split;
  const int b_end = min(nbins, b_begin + bins_per_split);
  const int tx = threadIdx.x % (TILE_R / MICRO);
  const int ty = threadIdx.x / (TILE_R / MICRO);

  float run_m2[MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i) run_m2[i] = -CUDART_INF_F;

  for (int bin = b_begin; bin < b_end; ++bin) {
    float m1[MICRO], m2[MICRO];
    int i1[MICRO];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[MICRO][MICRO];
      // rows >= N score -inf (score_tile gives them sq = +inf)
      score(q0, bin * BIN_L + half * TILE_R, st, s);
#pragma unroll
      for (int i = 0; i < MICRO; ++i) {
        const int base = half * TILE_R + tx * MICRO;
        float a1 = s[i][0];
        int ai = base;
        float a2 = -CUDART_INF_F;
#pragma unroll
        for (int j = 1; j < MICRO; ++j) {
          bin_fold(a1, ai, a2, s[i][j], base + j, -CUDART_INF_F);
        }
        // lanes tx = 0..15 of a half-warp share query ty * 4 + i
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          const float o1 = __shfl_xor_sync(FULL_MASK, a1, off);
          const int oi = __shfl_xor_sync(FULL_MASK, ai, off);
          const float o2 = __shfl_xor_sync(FULL_MASK, a2, off);
          bin_fold(a1, ai, a2, o1, oi, o2);
        }
        if (half == 0) {
          m1[i] = a1;
          i1[i] = ai;
          m2[i] = a2;
        } else {
          bin_fold(m1[i], i1[i], m2[i], a1, ai, a2);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const int qi = q0 + ty * MICRO + i;
      if (tx == 0 && qi < B) {
        sims[(size_t)qi * nbins + bin] = m1[i];
        ids[(size_t)qi * nbins + bin] = bin * BIN_L + i1[i];
      }
      run_m2[i] = m2[i] > run_m2[i] ? m2[i] : run_m2[i];
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const int qi = q0 + ty * MICRO + i;
      if (qi < B) m2_part[(size_t)split * B + qi] = run_m2[i];
    }
  }
}

__global__ void m2_reduce_kernel(const float* __restrict__ m2_part, int B,
                                 int splits, float* __restrict__ m2) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B) return;
  float m = -CUDART_INF_F;
  for (int sp = 0; sp < splits; ++sp) {
    const float v = m2_part[(size_t)sp * B + q];
    m = v > m ? v : m;
  }
  m2[q] = m;
}

}  // namespace rht

extern "C" int select_bins_launch(const float* q, const float* x,
                                  const float* qq, const float* sq, int B,
                                  int N, int D, int splits, float* sims,
                                  int* ids, float* m2_part, float* m2,
                                  cudaStream_t stream) {
  using namespace rht;
  if (B <= 0 || N <= 0) return 0;
  const int nbins = (N + BIN_L - 1) / BIN_L;
  if (splits < 1 || splits > nbins || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int bins_per_split = (nbins + splits - 1) / splits;
  const dim3 grid((B + TILE_Q - 1) / TILE_Q, splits);
  select_bins_kernel<<<grid, SCORE_THREADS, 0, stream>>>(
      EuclidScorer{q, x, qq, sq, B, N, D}, nbins, bins_per_split, sims, ids,
      m2_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  m2_reduce_kernel<<<(B + 255) / 256, 256, 0, stream>>>(m2_part, B, splits,
                                                         m2);
  return (int)cudaGetLastError();
}
