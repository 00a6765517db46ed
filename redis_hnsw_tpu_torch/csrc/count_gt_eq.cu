// Kernel B: per-query counts of rows scoring above and at a threshold.
//
// Replaces redis_hnsw_tpu/ops/pallas_count.py::count_gt_eq (the
// pl.pallas_call at :103, _count_kernel :54): the certificate's second
// pass. For each query b it counts the rows whose score is > t[b] and
// == t[b]. Dead rows carry sq = +inf and score -inf, so they count only
// against t = -inf, where the certificate ignores the tie count.
//
// Scores. The certificate compares these counts with counts over kernel
// A's selected scores, so every score must be kernel A's bit for bit:
// this kernel scores on the core of l2_core.cuh that kernels A and D
// share (fma_chunk's in-order __fmaf_rn chain, then l2_score).
//
// Bound on the H100: 2*B*N*D fp32 operations against (B + N)*D*4 bytes
// read -- compute-bound like the selection (7.8 ms at B = 2048, N = 1M,
// D = 128) -- with a cheaper epilogue: one compare per score where A has
// a list. So the design is kernel A's loop with its selection taken out:
//
// * A block (query tile, split) scores 128-query x 128-row tiles over a
//   contiguous range of tiles with 128 threads of 8 x 16 fp32 register
//   tiles, fed by the 3-stage cp.async ring (l2_core.cuh). The query
//   norms and thresholds are copied once per block, each tile's row norms
//   with its first chunk into a ring of their own, so the epilogue reads
//   no device memory.
// * Once a tile is scored, each thread tests its 16 scores of each of
//   its 8 queries against the query's threshold with one compare each
//   (s >= t). The certificate's t is a query's k-th best score, so almost
//   no score reaches it: only when a lane of the warp has one does the
//   warp count that query's scores -- recomputed, the same bits -- packing
//   the > count into the low and the == count into the high 16 bits of
//   one int (at most 16 each). The 8 lanes that share a query sum the
//   packed ints with three shuffles (at most 128 each), and the one lane
//   of them with tx == 0, the query's owner, adds the two counts to the
//   query's counters in shared memory: no atomics, and no counter held
//   in registers across the FMA loop, whose 8 x 16 accumulators already
//   take most of them. (tools/count_gt_eq_study.cu on an H100: counting
//   every tile without the vote ran 5% slower at B = 2048 over 1M rows,
//   16 counters a thread in registers as fast as that; the loop alone
//   takes 95% of the shipped kernel's time.) Where many scores reach t
//   (t = -inf) a warp scores its tile twice.
// * Rows >= N are excluded by index: their row norm is taken as NaN, so
//   their score is NaN and compares false with every threshold. (Scored
//   from zero operands with sq = +inf they would score -inf and count as
//   == against t = -inf; the plain version has no such rows.)
// * At the end each block adds its per-query counts into c_gt and c_eq
//   with integer atomics, once per (block, query): exact, whatever the
//   order. ops/cuda_count.py plans the splits from the card's resident
//   blocks of this kernel (count_gt_eq_slots), so that the blocks fill
//   whole waves.
//
// Shared memory: the ring (110,592 B), query norms (512 B), a ring of
// row norms (1,536 B), thresholds (512 B) and the counters (1,024 B):
// 114,176 B, 2 blocks (8 warps) per SM.
//
// C interface (ctypes, ops/cuda_count.py): count_gt_eq_launch (c_gt and
// c_eq zeroed by the caller; returns cudaGetLastError()),
// count_gt_eq_slots and count_gt_eq_smem_bytes.

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "l2_core.cuh"

namespace rht_count {

using namespace rht_l2;

// the operand ring, query norms, a ring of row norms and thresholds
// (floats), then the > and == counters (ints)
constexpr int SMEM_FLOATS = STAGES * STAGE_FLOATS + 2 * TILE_Q + STAGES * TILE_R;
constexpr int SMEM_BYTES = SMEM_FLOATS * (int)sizeof(float) +
                           2 * TILE_Q * (int)sizeof(int);

template <int VEC>
__global__ void __launch_bounds__(THREADS, 2)
    count_kernel(const float* __restrict__ Q, const float* __restrict__ X,
                 const float* __restrict__ qq, const float* __restrict__ sq,
                 const float* __restrict__ thr, int B, int N, int D,
                 int ntiles, int tiles_per_split, int* __restrict__ c_gt,
                 int* __restrict__ c_eq) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * TILE_Q;
  const int split = blockIdx.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  const int kch = max(1, (D + K_CHUNK - 1) / K_CHUNK);
  const int total = max(0, t_end - t_begin) * kch;
  const int tx = threadIdx.x % TR;
  const int ty = threadIdx.x / TR;

  float* const qq_s = smem + STAGES * STAGE_FLOATS;
  float* const sq_s = qq_s + TILE_Q;  // tile t's row norms at t % STAGES
  float* const th_s = sq_s + STAGES * TILE_R;
  int* const gt_s = reinterpret_cast<int*>(th_s + TILE_Q);
  int* const eq_s = gt_s + TILE_Q;
  gt_s[threadIdx.x] = 0;
  eq_s[threadIdx.x] = 0;
  // the loop's first barrier orders these before any read

  auto load = [&](int c) {
    const int t = t_begin + c / kch;
    const int part = c % kch;
    load_chunk<VEC>(smem + (c % STAGES) * STAGE_FLOATS, Q, X, B, N, D, q0,
                    t * TILE_R, part * K_CHUNK);
    if (part == 0) {
      const int r = t * TILE_R + threadIdx.x;
      cp_async<1>(sq_s + (t % STAGES) * TILE_R + threadIdx.x,
                  r < N ? sq + r : sq, r < N ? 4 : 0);
    }
  };
  {
    const int qi = q0 + threadIdx.x;  // past B: never counted
    cp_async<1>(qq_s + threadIdx.x, qi < B ? qq + qi : qq, qi < B ? 4 : 0);
    if (qi < B) {
      cp_async<1>(th_s + threadIdx.x, thr + qi, 4);
    } else {
      th_s[threadIdx.x] = CUDART_INF_F;  // no score reaches it
    }
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }

  float acc[MQ][MR];
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int j = 0; j < MR; ++j) acc[i][j] = 0.f;

  int kc = 0;
  int t = t_begin;
  for (int c = 0; c < total; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed (this thread's part)
    __syncthreads();  // ... everyone's; and chunk c - 1's slot is free
    if (c + STAGES - 1 < total) load(c + STAGES - 1);
    cp_async_commit();
    fma_chunk(smem + (c % STAGES) * STAGE_FLOATS, tx, ty, acc);
    if (++kc < kch) continue;

    // the tile is scored: count it (no device memory read)
    const int r0 = t * TILE_R;
    const float* const sq_t = sq_s + (t % STAGES) * TILE_R;
    float sn[MR];
#pragma unroll
    for (int j = 0; j < MR; ++j) {
      const int r = tx + j * TR;
      sn[j] = r0 + r < N ? sq_t[r] : CUDART_NAN_F;  // rows >= N: never count
    }
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      const int ql = ty + i * TQ;
      const float qn = qq_s[ql];
      const float th = th_s[ql];
      bool hit = false;
#pragma unroll
      for (int j = 0; j < MR; ++j) {
        hit |= l2_score(acc[i][j], qn, sn[j]) >= th;
      }
      if (__any_sync(FULL_MASK, hit)) {  // the whole warp: it shuffles
        int n = 0;  // > count in the low 16 bits, == count in the high 16
#pragma unroll
        for (int j = 0; j < MR; ++j) {
          const float s = l2_score(acc[i][j], qn, sn[j]);
          n += (s > th) + ((s == th) << 16);
        }
#pragma unroll
        for (int off = TR / 2; off > 0; off >>= 1) {
          n += __shfl_xor_sync(FULL_MASK, n, off);
        }
        if (tx == 0) {
          gt_s[ql] += n & 0xffff;
          eq_s[ql] += n >> 16;
        }
      }
#pragma unroll
      for (int j = 0; j < MR; ++j) acc[i][j] = 0.f;
    }
    kc = 0;
    ++t;
  }
  cp_async_wait<0>();  // no copy outlives the block (an empty split)
  __syncthreads();     // every owner's counts are in
  const int qi = q0 + threadIdx.x;
  if (qi < B) {
    const int gt = gt_s[threadIdx.x], eq = eq_s[threadIdx.x];
    if (gt) atomicAdd(&c_gt[qi], gt);
    if (eq) atomicAdd(&c_eq[qi], eq);
  }
}

template <int VEC>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(count_kernel<VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

template <int VEC>
int blocks_per_sm() {
  int n = 0;
  if (allow_smem<VEC>() != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, count_kernel<VEC>, THREADS, SMEM_BYTES) != cudaSuccess) {
    return -1;
  }
  return n;
}

}  // namespace rht_count

// Resident blocks of kernel B the current card holds at once (the fewer
// of its two forms), or a negative value on failure.
extern "C" int count_gt_eq_slots() {
  using namespace rht_count;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return -1;
  }
  const int a = blocks_per_sm<4>();
  const int b = blocks_per_sm<1>();
  if (a <= 0 || b <= 0) return -1;
  return (a < b ? a : b) * sms;
}

// The dynamic shared memory of one block, in bytes.
extern "C" int count_gt_eq_smem_bytes() { return rht_count::SMEM_BYTES; }

extern "C" int count_gt_eq_launch(const float* q, const float* x,
                                  const float* qq, const float* sq,
                                  const float* t, int B, int N, int D,
                                  int splits, int* c_gt, int* c_eq,
                                  cudaStream_t stream) {
  using namespace rht_count;
  if (B <= 0 || N <= 0) return 0;
  const int ntiles = (N + TILE_R - 1) / TILE_R;
  if (splits < 1 || splits > ntiles || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_per_split = (ntiles + splits - 1) / splits;
  const dim3 grid((B + TILE_Q - 1) / TILE_Q, splits);
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err = vec4 ? allow_smem<4>() : allow_smem<1>();
  if (err != cudaSuccess) return (int)err;
  if (vec4) {
    count_kernel<4><<<grid, THREADS, SMEM_BYTES, stream>>>(
        q, x, qq, sq, t, B, N, D, ntiles, tiles_per_split, c_gt, c_eq);
  } else {
    count_kernel<1><<<grid, THREADS, SMEM_BYTES, stream>>>(
        q, x, qq, sq, t, B, N, D, ntiles, tiles_per_split, c_gt, c_eq);
  }
  return (int)cudaGetLastError();
}
