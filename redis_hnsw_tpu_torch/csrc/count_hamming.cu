// Kernel B′: per-query counts of hamming rows scoring above and at a
// threshold -- the certified hamming tier's second pass.
//
// Replaces the XLA count of the JAX package's certified hamming tier,
// redis_hnsw_tpu/ops/scan.py::_count_vs_threshold_hamming (:897; no
// Pallas kernel there). For each query b it counts the rows whose score
//
//     score = bias[row] - popcount(q XOR x)
//
// is > t[b] and == t[b]; bias is 0 on a live row and -inf on a dead one,
// so a dead row scores -inf and counts as == against t = -inf only (the
// certificate's escape clause at t = -inf relies on that; the JAX
// package masks dead rows to -inf the same way). Rows >= N never count.
//
// Scores. The certificate compares these counts with counts over kernel
// A′'s selection, so both must score alike. Hamming counts are small
// integers, exact on any unit, so they agree by arithmetic; and both
// kernels compute them on the one int8 tensor-core core of
// hamming_mma.cuh (MmaCore: mma.sync m16n8k32, the queries as +-1 bytes,
// the rows as 0/1 bytes, dot = popc(q) - popc(q XOR x)).
//
// Bound on the H100: as A′, 2*B*N*32W int8 tensor-core operations
// (0.490 ms at B = 2048, N = 1,000,064, W = 8 at the dense int8 peak), or
// B*N*W popcounts on the CUDA cores (3.92 ms), against (B + N)*W*4 bytes
// read. So the design is A′'s loop with the selection taken out:
//
// * A block (query tile, split) scores 128-query x 128-row tiles over a
//   contiguous range of tiles with 128 threads (4 warps of 32 rows x 128
//   queries); the row words and bias stream through A′'s 3-stage
//   cp.async ring (load_words), and the tile's queries are expanded to
//   bytes once per 8-word chunk (once per block for W <= 8).
// * The threshold becomes two integer keys per query, once per block: a
//   live row's score -count is > t iff count < ceil(-t), i.e. iff dot >
//   popc(q) - ceil(-t); == t iff -t is an integer and dot == popc(q) + t
//   (clamped to 0 .. 32W + 1; t = -inf: every live row is >, t = +inf or
//   NaN: none). Once a tile is scored, each thread tests its 8 counts of
//   each of its 16 (query, half) pairs against the pair's keys (shared
//   memory) and adds the popcounts of the two masks, ANDed with the
//   tile's live rows, into 32 counters in registers.
// * Each thread also counts its own row of each tile if it is dead (< N,
//   bias -inf): the block's dead rows count as == for the queries whose
//   t is -inf.
// * At the end the 4 lanes that share a query sum their counters by
//   shuffles, one adds them to the query's counters in shared memory
//   (one shared atomic per warp and query), and thread q adds query q's
//   counts into c_gt and c_eq with integer atomics, once per (block,
//   query): exact, whatever the order. ops/cuda_count_hamming.py plans the
//   splits from the card's resident blocks of this kernel
//   (count_hamming_slots), so that the blocks fill whole waves.
//
// Shared memory: the word ring (12,288 B), a ring of bias rows (1,536
// B), the query bytes (32,768 B), two keys and two counters a query
// (2,048 B) and the dead-row count: 48,656 B a block.
//
// C interface (ctypes, ops/cuda_count_hamming.py): count_hamming_launch
// (c_gt and c_eq zeroed by the caller; returns cudaGetLastError()),
// count_hamming_slots and count_hamming_smem_bytes.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "hamming_mma.cuh"

namespace rht_hcount {

using namespace rht_ham;
using rht_l2::cp_async_commit;
using rht_l2::cp_async_wait;

constexpr unsigned FULL = 0xffffffffu;

// the word ring and the bias ring, the query bytes, then per query its
// > key, == key, > counter and == counter, then the block's dead rows
constexpr int SMEM_BYTES = STAGES * STAGE_WORDS * 4 + STAGES * TILE * 4 +
                           MmaCore::QS_BYTES + 4 * TILE * 4 + 16;

// The keys of a query with popcount popcq over W words against the
// threshold th: a live row counts as > iff its dot exceeds *gt_key, as
// == iff its dot equals *eq_key (INT_MIN: never; every dot is >= -32W).
__device__ __forceinline__ void thresholds(float th, int popcq, int W,
                                           int* gt_key, int* eq_key) {
  const float x = -th;  // a live row of count c: > th iff c < x
  const int top = 32 * W;
  int lim = 0;       // rows with count < lim are > th
  int eqc = -1;      // the count that is == th (-1: none)
  if (x != x) {      // NaN: nothing compares
  } else if (x > (float)top) {
    lim = top + 1;
  } else if (x >= 0.f) {
    lim = (int)ceilf(x);
    if (floorf(x) == x) eqc = (int)x;
  }
  *gt_key = popcq - lim;
  *eq_key = eqc < 0 ? INT_MIN : popcq - eqc;
}

template <int VEC>
__global__ void __launch_bounds__(THREADS, 2)
    count_hamming_kernel(const int* __restrict__ Q, const int* __restrict__ X,
                         const float* __restrict__ bias,
                         const float* __restrict__ thr, int B, int N, int W,
                         int ntiles, int tiles_per_split,
                         int* __restrict__ c_gt, int* __restrict__ c_eq) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* const ring = reinterpret_cast<int*>(smem);
  float* const bias_s = reinterpret_cast<float*>(ring + STAGES * STAGE_WORDS);
  unsigned char* const qs =
      reinterpret_cast<unsigned char*>(bias_s + STAGES * TILE);
  int* const gtk_s = reinterpret_cast<int*>(qs + MmaCore::QS_BYTES);
  int* const eqk_s = gtk_s + TILE;
  int* const gt_s = eqk_s + TILE;
  int* const eq_s = gt_s + TILE;
  int* const dead_s = eq_s + TILE;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TILE;
  const int split = blockIdx.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  const int nch = max(1, (W + WC - 1) / WC);
  const int total = max(0, t_end - t_begin) * nch;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int row0 = warp * 32 + 2 * tig;  // bit j of a mask: + 8(j/2) + j%2

  // thread tid: query q0 + tid's keys (past B: counted never)
  const int q = q0 + tid;
  float th = CUDART_INF_F;
  int popcq = 0;
  if (q < B) {
    th = thr[q];
    for (int w = 0; w < W; ++w) popcq += __popc(Q[(size_t)q * W + w]);
  }
  thresholds(th, popcq, W, &gtk_s[tid], &eqk_s[tid]);
  gt_s[tid] = 0;
  eq_s[tid] = 0;
  if (tid == 0) *dead_s = 0;
  // the loop's first barrier orders these before any read

  auto load = [&](int u) {
    const int t = t_begin + u / nch;
    const int part = u % nch;
    load_words<VEC>(ring + (u % STAGES) * STAGE_WORDS, X, N, W, t * TILE,
                    part * WC);
    if (part == 0) {
      const int r = t * TILE + tid;
      cp_async<1>(bias_s + (t % STAGES) * TILE + tid, r < N ? bias + r : bias,
                  r < N ? 4 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }

  int cgt[16], ceq[16];  // pair mh = 2m + h: query 16m + g + 8h
#pragma unroll
  for (int i = 0; i < 16; ++i) cgt[i] = ceq[i] = 0;
  int dead = 0;  // this thread's rows (row tid of each tile) that are dead
  MmaCore::Acc acc;
  MmaCore::zero(acc);
  for (int u = 0; u < total; ++u) {
    const int t = t_begin + u / nch;
    const int part = u % nch;
    cp_async_wait<STAGES - 2>();  // unit u has landed (this thread's part)
    __syncthreads();  // ... everyone's; and unit u - 1's slot is free
    if (u + STAGES - 1 < total) load(u + STAGES - 1);
    cp_async_commit();
    const int w0 = part * WC;
    const int wn = min(WC, W - w0);
    if (nch > 1 || u == 0) {
      MmaCore::stage(qs, Q, B, W, q0, w0, wn);
      __syncthreads();
    }
    MmaCore::chunk(qs, ring + (u % STAGES) * STAGE_WORDS, wn, acc);
    if (part + 1 < nch) continue;

    // the tile is scored: count it (no device memory read)
    const int r0 = t * TILE;
    const float* const bias_t = bias_s + (t % STAGES) * TILE;
    dead += r0 + tid < N && bias_t[tid] == -CUDART_INF_F;
    unsigned live8 = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int rl = row0 + 8 * (j / 2) + j % 2;
      live8 |= (unsigned)(r0 + rl < N && bias_t[rl] != -CUDART_INF_F) << j;
    }
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ql = 16 * m + g + 8 * h;
        const int kg = gtk_s[ql], ke = eqk_s[ql];
        unsigned mg = 0, me = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int v = acc.c[m][j / 2][2 * h + j % 2];
          mg |= (unsigned)(v > kg) << j;
          me |= (unsigned)(v == ke) << j;
        }
        cgt[2 * m + h] += __popc(mg & live8);
        ceq[2 * m + h] += __popc(me & live8);
      }
    MmaCore::zero(acc);
  }
  cp_async_wait<0>();  // no copy outlives the block (an empty split)

  // the 4 lanes of a group share their queries: sum, then one lane adds
  // the warp's counts into the query's shared counters
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      cgt[i] += __shfl_xor_sync(FULL, cgt[i], off);
      ceq[i] += __shfl_xor_sync(FULL, ceq[i], off);
    }
  }
  if (tig == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int ql = 16 * (i / 2) + g + 8 * (i % 2);
      if (cgt[i]) atomicAdd(&gt_s[ql], cgt[i]);
      if (ceq[i]) atomicAdd(&eq_s[ql], ceq[i]);
    }
  }
  if (dead) atomicAdd(dead_s, dead);
  __syncthreads();
  if (q < B) {
    const int gt = gt_s[tid];
    const int eq = eq_s[tid] + (th == -CUDART_INF_F ? *dead_s : 0);
    if (gt) atomicAdd(&c_gt[q], gt);
    if (eq) atomicAdd(&c_eq[q], eq);
  }
}

template <int VEC>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(count_hamming_kernel<VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

template <int VEC>
int blocks_per_sm() {
  int n = 0;
  if (allow_smem<VEC>() != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, count_hamming_kernel<VEC>, THREADS, SMEM_BYTES) !=
      cudaSuccess) {
    return -1;
  }
  return n;
}

}  // namespace rht_hcount

// Resident blocks of kernel B′ the current card holds at once (the fewer
// of its two forms), or a negative value on failure.
extern "C" int count_hamming_slots() {
  using namespace rht_hcount;
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
extern "C" int count_hamming_smem_bytes() { return rht_hcount::SMEM_BYTES; }

// bias is 0 on a live row and -inf on a dead one.
extern "C" int count_hamming_launch(const int* q, const int* x,
                                    const float* bias, const float* t, int B,
                                    int N, int W, int splits, int* c_gt,
                                    int* c_eq, cudaStream_t stream) {
  using namespace rht_hcount;
  if (B <= 0 || N <= 0) return 0;
  const int ntiles = (N + TILE - 1) / TILE;
  if (W < 1 || splits < 1 || splits > ntiles || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_per_split = (ntiles + splits - 1) / splits;
  const dim3 grid((B + TILE - 1) / TILE, splits);
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err = vec4 ? allow_smem<4>() : allow_smem<1>();
  if (err != cudaSuccess) return (int)err;
  if (vec4) {
    count_hamming_kernel<4><<<grid, THREADS, SMEM_BYTES, stream>>>(
        q, x, bias, t, B, N, W, ntiles, tiles_per_split, c_gt, c_eq);
  } else {
    count_hamming_kernel<1><<<grid, THREADS, SMEM_BYTES, stream>>>(
        q, x, bias, t, B, N, W, ntiles, tiles_per_split, c_gt, c_eq);
  }
  return (int)cudaGetLastError();
}
