// Kernels A and A': fused exact scan top-k over the whole table.
//
// Replaces redis_hnsw_tpu/ops/pallas_scan.py::flat_topk_pallas (the
// pl.pallas_call at :194, _scan_kernel_euclid :88, _scan_kernel_hamming
// :122, _merge_topk :50). Per query, the exact top-k rows of the table by
// score (csrc/score.cuh), best first, ties to the lowest row id, (-inf,
// -1) in empty slots. Dead rows score -inf (sq = +inf in the euclidean
// form, bias = -inf in the hamming form) and are never selected. The
// split and merge kernels are templated on the scorer, so A (euclidean)
// and A' (hamming) share every line of the selection.
//
// The Pallas kernel walks the rows in grid order and carries a running
// best from one step to the next. Blocks on the H100 run in no order, so:
//   1. topk_split_kernel: the rows are cut into `splits` contiguous
//      ranges; block (query tile, split) scores its 64 queries against
//      its range (score.cuh tiles) and keeps, per query, a sorted
//      top-k list in shared memory. A candidate enters only if it beats
//      the list's k-th entry; one warp owns each query's list and
//      inserts cooperatively (ballot for the position, shift, write).
//   2. topk_merge_kernel: one warp per query merges the `splits` sorted
//      partial lists under the total order (-score, row id).
// Both orders are strict on real rows, so the result does not depend on
// the split count or on the order in which rows are seen.
//
// Bound on the H100: the scoring is 2*B*N*D fp32 operations (no tensor
// cores: exact tiers are true fp32), against (B + N)*D*4 bytes read, so
// the kernel is compute-bound at every serving shape; the selection adds
// a compare per score and ~k*ln(N/k) insertions per query and split.
// A' is bound by its B*N*W popcounts (16 per clock per SM) against
// (B + N)*W*4 bytes, compute-bound too; its selection epilogue is A's.
// This first version is simple and right: a 4x4 register tile and a
// shared-memory list; it is not tuned.
//
// C interface (ctypes, ops/cuda_scan.py): scan_topk_launch (A) and
// scan_topk_hamming_launch (A'); each returns cudaGetLastError().

#include <climits>

#include "score.cuh"

namespace rht {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_KCAP = 256;
constexpr int TILE_LD = TILE_R + 1;

// (as, ai) ranks strictly before (bs, bi): higher score, then lower id.
__device__ __forceinline__ bool beats(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// Insert (vs, vid) into the sorted list ls/li of length k, which it is
// known to beat at slot k-1. Called by all 32 lanes of one warp.
__device__ __forceinline__ void warp_insert(float* ls, int* li, int k,
                                            float vs, int vid, int lane) {
  int pos = 0;
  for (int base = 0; base < k; base += 32) {
    const int j = base + lane;
    const bool b = j < k && beats(ls[j], li[j], vs, vid);
    pos += __popc(__ballot_sync(FULL_MASK, b));
  }
  float hs[MAX_KCAP / 32];
  int hi[MAX_KCAP / 32];
#pragma unroll
  for (int c = 0; c < MAX_KCAP / 32; ++c) {
    const int j = c * 32 + lane;
    if (j >= pos && j < k - 1) {
      hs[c] = ls[j];
      hi[c] = li[j];
    }
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < MAX_KCAP / 32; ++c) {
    const int j = c * 32 + lane;
    if (j >= pos && j < k - 1) {
      ls[j + 1] = hs[c];
      li[j + 1] = hi[c];
    }
  }
  __syncwarp();
  if (lane == 0) {
    ls[pos] = vs;
    li[pos] = vid;
  }
  __syncwarp();
}

template <class Scorer>
__global__ void __launch_bounds__(SCORE_THREADS)
    topk_split_kernel(const Scorer score, int k, int kcap,
                      int rows_per_split, float* __restrict__ part_s,
                      int* __restrict__ part_i) {
  using Stage = typename Scorer::Stage;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage& st = *reinterpret_cast<Stage*>(smem);
  float(*tile)[TILE_LD] =
      reinterpret_cast<float(*)[TILE_LD]>(smem + sizeof(Stage));
  float* ls = reinterpret_cast<float*>(smem + sizeof(Stage) +
                                       sizeof(float) * TILE_Q * TILE_LD);
  int* li = reinterpret_cast<int*>(ls + TILE_Q * kcap);
  const int B = score.B;
  const int N = score.N;

  const int q0 = blockIdx.x * TILE_Q;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tx = threadIdx.x % (TILE_R / MICRO);
  const int ty = threadIdx.x / (TILE_R / MICRO);

  for (int e = threadIdx.x; e < TILE_Q * kcap; e += SCORE_THREADS) {
    ls[e] = -CUDART_INF_F;
    li[e] = INT_MAX;
  }
  // the scorer's first __syncthreads orders these writes before any read

  for (int r0 = r_begin; r0 < r_end; r0 += TILE_R) {
    float s[MICRO][MICRO];
    // the scorer synchronises the block before it stages, so every
    // warp has finished reading the previous tile when it is rewritten
    score(q0, r0, st, s);
#pragma unroll
    for (int i = 0; i < MICRO; ++i)
#pragma unroll
      for (int j = 0; j < MICRO; ++j) {
        const int ri = r0 + tx * MICRO + j;
        tile[ty * MICRO + i][tx * MICRO + j] =
            ri < r_end ? s[i][j] : -CUDART_INF_F;
      }
    __syncthreads();
    for (int qi = warp; qi < TILE_Q && q0 + qi < B;
         qi += SCORE_THREADS / 32) {
      float* qs = ls + qi * kcap;
      int* qids = li + qi * kcap;
      for (int half = 0; half < TILE_R; half += 32) {
        const float cs = tile[qi][half + lane];
        const int cid = r0 + half + lane;
        const bool want =
            cs > -CUDART_INF_F && beats(cs, cid, qs[k - 1], qids[k - 1]);
        unsigned mask = __ballot_sync(FULL_MASK, want);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float vs = __shfl_sync(FULL_MASK, cs, src);
          const int vid = __shfl_sync(FULL_MASK, cid, src);
          // the k-th entry may have risen since the ballot; the check
          // reads one shared value, so the branch is warp-uniform
          if (beats(vs, vid, qs[k - 1], qids[k - 1])) {
            warp_insert(qs, qids, k, vs, vid, lane);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TILE_Q * k; e += SCORE_THREADS) {
    const int qi = e / k;
    const int j = e % k;
    if (q0 + qi < B) {
      const size_t o = ((size_t)split * B + q0 + qi) * k + j;
      part_s[o] = ls[qi * kcap + j];
      part_i[o] = li[qi * kcap + j];
    }
  }
}

__global__ void topk_merge_kernel(const float* __restrict__ part_s,
                                  const int* __restrict__ part_i, int B,
                                  int k, int splits,
                                  float* __restrict__ out_s,
                                  int* __restrict__ out_i) {
  const int q = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (q >= B) return;  // whole warps only: blockDim.x is a multiple of 32
  int p = 0;
  float hs = -CUDART_INF_F;
  int hid = INT_MAX;
  if (lane < splits) {
    const size_t o = ((size_t)lane * B + q) * k;
    hs = part_s[o];
    hid = part_i[o];
  }
  for (int j = 0; j < k; ++j) {
    float bs = hs;
    int bid = hid;
    int bl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(FULL_MASK, bs, off);
      const int oid = __shfl_xor_sync(FULL_MASK, bid, off);
      const int ol = __shfl_xor_sync(FULL_MASK, bl, off);
      if (beats(os, oid, bs, bid)) {
        bs = os;
        bid = oid;
        bl = ol;
      }
    }
    const bool valid = bs > -CUDART_INF_F;
    if (lane == 0) {
      out_s[(size_t)q * k + j] = valid ? bs : -CUDART_INF_F;
      out_i[(size_t)q * k + j] = valid ? bid : -1;
    }
    if (!valid) {
      // every remaining head is empty: pad the rest of the row
      for (int jj = j + 1 + lane; jj < k; jj += 32) {
        out_s[(size_t)q * k + jj] = -CUDART_INF_F;
        out_i[(size_t)q * k + jj] = -1;
      }
      break;
    }
    if (lane == bl) {
      ++p;
      hs = -CUDART_INF_F;
      hid = INT_MAX;
      if (p < k) {
        const size_t o = ((size_t)lane * B + q) * k + p;
        hs = part_s[o];
        hid = part_i[o];
      }
    }
  }
}

}  // namespace rht

namespace rht {

template <class Scorer>
int launch_topk(const Scorer& score, int k, int splits, float* part_s,
                int* part_i, float* out_s, int* out_i,
                cudaStream_t stream) {
  const int B = score.B;
  if (B <= 0 || k <= 0) return 0;
  if (k > MAX_KCAP || splits < 1 || splits > 32) {
    return (int)cudaErrorInvalidValue;
  }
  const int kcap = ((k + 31) / 32) * 32;
  const int tiles = (score.N + TILE_R - 1) / TILE_R;
  const int rows_per_split = ((tiles + splits - 1) / splits) * TILE_R;
  const size_t smem = sizeof(typename Scorer::Stage) +
                      sizeof(float) * TILE_Q * TILE_LD +
                      (sizeof(float) + sizeof(int)) * TILE_Q * kcap;
  cudaError_t err = cudaFuncSetAttribute(
      topk_split_kernel<Scorer>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TILE_Q - 1) / TILE_Q, splits);
  topk_split_kernel<Scorer><<<grid, SCORE_THREADS, smem, stream>>>(
      score, k, kcap, rows_per_split, part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps_per_block = 8;
  topk_merge_kernel<<<(B + warps_per_block - 1) / warps_per_block,
                      32 * warps_per_block, 0, stream>>>(
      part_s, part_i, B, k, splits, out_s, out_i);
  return (int)cudaGetLastError();
}

}  // namespace rht

extern "C" int scan_topk_launch(const float* q, const float* x,
                                const float* qq, const float* sq, int B,
                                int N, int D, int k, int splits,
                                float* part_s, int* part_i, float* out_s,
                                int* out_i, cudaStream_t stream) {
  return rht::launch_topk(rht::EuclidScorer{q, x, qq, sq, B, N, D}, k,
                          splits, part_s, part_i, out_s, out_i, stream);
}

extern "C" int scan_topk_hamming_launch(const int* q, const int* x,
                                        const float* bias, int B, int N,
                                        int W, int k, int splits,
                                        float* part_s, int* part_i,
                                        float* out_s, int* out_i,
                                        cudaStream_t stream) {
  return rht::launch_topk(rht::HammingScorer{q, x, bias, B, N, W}, k,
                          splits, part_s, part_i, out_s, out_i, stream);
}
