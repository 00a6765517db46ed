// Kernels A and A': fused exact scan top-k over the whole table.
//
// Replaces redis_hnsw_tpu/ops/pallas_scan.py::flat_topk_pallas (the
// pl.pallas_call at :194, _scan_kernel_euclid :88, _scan_kernel_hamming
// :122, _merge_topk :50). Per query, the exact top-k rows of the table by
// score, best first, ties to the lowest row id, (-inf, -1) in empty
// slots. Dead rows score -inf (sq = +inf in the euclidean form, bias =
// -inf in the hamming form) and are never selected.
//
// The Pallas kernel walks the rows in grid order and carries a running
// best from one step to the next. Blocks on the H100 run in no order, so
// both kernels cut the rows into `splits` contiguous ranges, select a
// sorted top-k list per (split, query), and merge the lists per query
// under the total order (-score, row id). That order is strict on real
// rows, so the result depends neither on the split count nor on the order
// in which rows are seen.
//
// Kernel A (euclidean; scan_tile_kernel, list_merge_kernel) -- the exact
// tier, the two-pass certified selection, the one-pass fallback, flat
// use_pallas and the graph engine's seed pivots.
//
//   Scores. On the fp32 core of l2_core.cuh, which kernel B (the
//   two-pass certificate's count) and kernel D (the one-pass select)
//   share, so the three kernels' scores are bit-identical:
//     dot   = one __fmaf_rn chain over d = 0 .. D-1 in order, from +0
//     score = __fsub_rn(__fsub_rn(__fmul_rn(2, dot), qq), sq)
//   No tensor cores, no TF32, no split-K, no reassociation.
//
//   Bound on the H100: 2*B*N*D fp32 operations against (B + N)*D*4 bytes,
//   compute-bound at every serving shape (7.8 ms at B = 2048, N = 1M,
//   D = 128). The core: a block scores a 128-query x 128-row tile with
//   128 threads, each holding an 8 x 16 fp32 register tile (queries
//   ty + 16i, i < 8, and rows tx + 8j, j < 16; tx = tid % 8, ty = tid /
//   8), 32 FMAs per 16-byte shared load; operands stream through a
//   3-stage cp.async ring of 32-dim chunks that runs on across row tiles
//   (16-byte copies; a 4-byte-copy instance when D % 4 != 0 or an operand
//   is not 16-byte aligned).
//
//   Selection. A score leaves the registers only if it may enter the
//   list. Per (split, query) the list is an 8-ary heap of k entries in
//   device memory whose root is its worst entry, followed by an append
//   buffer of BUF_CAP entries (a "slab"). Each thread tests its 8 x 16
//   scores against its 8 queries' thresholds -- the heap roots' scores,
//   kept per query in shared memory -- with one compare each (score >=
//   threshold); a survivor is appended to its query's buffer through a
//   per-query counter in shared memory. A query's 128 scores of a tile
//   sit in 8 lanes of one warp, so each query is owned by one lane of
//   that warp (lane l owns query 4w + l/8 + 16(l%8) of warp w). After a
//   tile, if any buffer could not take another tile, every owner lane
//   sifts its buffer into its heap (ties settled by id, as the total order
//   wants) and refreshes its threshold: all warps at once, so the block
//   stalls once, and where the accumulators are zero, so the merge has
//   the registers. The root and its 8 children stay in registers during
//   a merge, so an insertion reads no device memory for k <= 9 and one
//   level of it for k <= 73. A threshold is stale between merges, which
//   only admits more; the heap settles every admitted row, so each
//   split's list is its exact top-k. At the split's end the owner drains
//   the buffer and heap-sorts the list in place, best first. Nothing
//   bounds k but device memory: every k the JAX package serves, kernel A
//   serves.
//
//   Shared memory: the ring (110,592 B), query norms (512 B), a ring of
//   row norms (1,536 B), thresholds and counters (512 B each) and 4
//   votes: 113,680 B, 2 blocks (8 warps) per SM. ops/cuda_scan.py plans
//   the splits from the card's resident block slots (scan_topk_slots),
//   so the blocks fill whole waves at B = 2048 and at a single query
//   tile.
//
//   list_merge_kernel: one warp per query merges the `splits` sorted
//   lists, any number of them: lane l holds the best head of lists l,
//   l + 32, ...; the warp takes the best of the lanes', and the winner
//   advances that list and rescans its own.
//
// Kernel A′ (hamming; hamming_tile_kernel<MmaCore>, list_merge_kernel)
// -- the exact hamming tier, flat use_pallas on a hamming table and the
// hamming graph engine's seed pivots. score = bias - popcount(q XOR x)
// over W int32 words, bias 0 on a live row and -inf on a dead one.
//
//   Bound on the H100: as popcounts, B*N*W of them at 16 per clock per
//   SM (3.92 ms at B = 2048, N = 1M, W = 8); as the +-1 dot product that
//   the JAX package's matmul form computes, 2*B*N*32W int8 operations on
//   the tensor cores (0.53 ms at the dense int8 peak), against (B + N)*W*4
//   bytes. So A′ scores on the tensor cores: mma.sync m16n8k32 s8 x s8 ->
//   s32, the queries as +-1 bytes, the rows as 0/1 bytes, and count =
//   popc(q) - dot, exact in int32 (MmaCore, in hamming_mma.cuh; the bit
//   -> byte order and the identity are at its definition). score = __fsub_rn(bias, (float) count): the plain
//   version's bits. wgmma and TMA are left for later.
//
//   Selection: kernel A's. A block scores a 128-query x 128-row tile with
//   128 threads (4 warps of 32 rows x 128 queries); the row words and
//   bias stream through a 3-stage cp.async ring of 128-row x 8-word
//   chunks (16-byte copies where W % 4 == 0 and the table is aligned,
//   else 4-byte ones), and the tile's queries are expanded to bytes once
//   per 8-word chunk (once per block for W <= 8). Each count is tested in
//   registers against its query's key (shared memory); a warp appends a
//   query's survivors to the (split, query) slab's buffer with one shared
//   atomic (MmaCore::each). Thread q owns query q's heap: before a tile's
//   appends, once some buffer holds more than DRAIN_AT (16) entries,
//   every owner drains its buffer into its heap (one vote barrier a
//   tile). Draining that early keeps the keys fresh: 40-50% fewer
//   appends than draining only when a buffer could not take a tile.
//   The heaps, drain, heap-sort and list_merge_kernel are kernel A's, so
//   nothing bounds k but device memory, and the splits are planned from
//   A′'s own resident blocks and its fixed work a split (ops/cuda_scan.py
//   plan): at B = 2048 over 1M rows, one wave of 16 long splits, not two
//   of 33. Where the time goes, and the forms tried, is in
//   tools/hamming_core_study.cu and PERF.md.
//
// The selection's code (the slabs' heaps, drain, sift_down and
// list_merge_kernel) is in scan_heap.cuh, which the bf16 and int8 tiers'
// cores (scan_lowp.cu) share.
//
// C interface (ctypes, ops/cuda_scan.py): scan_topk_launch (A),
// scan_topk_slots, scan_topk_slab_len, scan_topk_smem_bytes,
// scan_topk_hamming_launch (A′), scan_topk_hamming_slots and
// scan_topk_hamming_smem_bytes; the launches return cudaGetLastError().

#include "hamming_mma.cuh"
#include "scan_heap.cuh"

// -- kernel A -------------------------------------------------------------

namespace rht_scan {

using namespace rht_l2;

constexpr int WARPS = THREADS / 32;
// the operand ring, the tile's query norms and a ring of row norms
// (floats), then the queries' thresholds (floats), append counters and
// the warps' merge votes
constexpr int RING_FLOATS = STAGES * STAGE_FLOATS + TILE_Q + STAGES * TILE_R;
constexpr int SMEM_BYTES = RING_FLOATS * (int)sizeof(float) +
                           TILE_Q * (int)(sizeof(float) + sizeof(int)) +
                           WARPS * (int)sizeof(int);

static_assert(WARPS == 4, "a tile's votes are one int4");

template <int VEC>
__global__ void __launch_bounds__(THREADS, 2)
    scan_tile_kernel(const float* __restrict__ Q,
                     const float* __restrict__ X,
                     const float* __restrict__ qq,
                     const float* __restrict__ sq, int B, int N, int D,
                     int k, int ntiles, int tiles_per_split, int slab_len,
                     int2* __restrict__ slabs) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * TILE_Q;
  const int split = blockIdx.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  const int kch = max(1, (D + K_CHUNK - 1) / K_CHUNK);
  const int total = max(0, t_end - t_begin) * kch;
  const int tx = threadIdx.x % TR;
  const int ty = threadIdx.x / TR;
  const int lane = threadIdx.x % 32;
  // the query whose list this lane owns: one of the 8 its lanes score
  const int own = (threadIdx.x / 32) * 4 + lane / 8 + TQ * (lane % 8);
  const bool own_live = q0 + own < B;

  float* const qq_s = smem + STAGES * STAGE_FLOATS;
  float* const sq_s = qq_s + TILE_Q;  // tile t's row norms at t % STAGES
  float* const thr_s = smem + RING_FLOATS;
  int* const cnt_s = reinterpret_cast<int*>(thr_s + TILE_Q);
  int4* const vote_s = reinterpret_cast<int4*>(cnt_s + TILE_Q);
  int2* const slab0 = slabs + ((size_t)split * B + q0) * slab_len;
  int2* const heap = slab0 + (size_t)own * slab_len + HEAP_AT;

  // queries past B get a threshold no score reaches: they append nothing
  thr_s[threadIdx.x] = q0 + (int)threadIdx.x < B ? threshold(empty_entry())
                                                 : CUDART_INF_F;
  cnt_s[threadIdx.x] = 0;
  if (own_live) {
    for (int i = 0; i < k; ++i) heap[i] = empty_entry();
  }
  __syncthreads();

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
    const int qi = q0 + threadIdx.x;  // zero past B
    cp_async<1>(qq_s + threadIdx.x, qi < B ? qq + qi : qq, qi < B ? 4 : 0);
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

    // the tile is scored: admit what beats each query's threshold
    const int r0 = t * TILE_R;
    const float* const sq_t = sq_s + (t % STAGES) * TILE_R;
    float sn[MR];
#pragma unroll
    for (int j = 0; j < MR; ++j) {
      const int r = tx + j * TR;
      sn[j] = r0 + r < N ? sq_t[r] : CUDART_INF_F;  // rows >= N: -inf
    }
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      const int ql = ty + i * TQ;
      const float qn = qq_s[ql];
      const float th = thr_s[ql];
#pragma unroll
      for (int j = 0; j < MR; ++j) {
        const float s = l2_score(acc[i][j], qn, sn[j]);
        acc[i][j] = 0.f;
        if (s >= th) {
          const int p = atomicAdd(&cnt_s[ql], 1);
          slab0[(size_t)ql * slab_len + heap_len(k) + p] =
              make_int2(__float_as_int(s), r0 + tx + j * TR);
        }
      }
    }
    __syncwarp();  // the warp's appends and counts are in
    // a warp votes for a merge if one of its buffers could not take
    // another tile; then, if any warp did, every lane merges its buffer,
    // all warps at once, so the block stalls once for them all (and here,
    // where the accumulators are zero, so the merge has the registers)
    const bool full = __any_sync(FULL_MASK, cnt_s[own] >= BUF_CAP - TILE_R);
    if (lane == 0) reinterpret_cast<int*>(vote_s)[threadIdx.x / 32] = full;
    __syncthreads();
    const int4 v = *vote_s;
    if (v.x | v.y | v.z | v.w) {
      const int n = cnt_s[own];
      if (n > 0) {
        thr_s[own] = threshold(drain(heap, k, n));
        cnt_s[own] = 0;
      }
      __syncwarp();
    }
    kc = 0;
    ++t;
  }
  cp_async_wait<0>();  // no copy outlives the block (an empty split)
  __syncwarp();
  if (own_live) {
    drain(heap, k, cnt_s[own]);
    // heap-sort in place: the list g[0..k), best first
    for (int m = k - 1; m >= 1; --m) {
      const int2 last = heap[m];
      heap[m] = heap[0];
      heap[0] = sift_down(heap, m, 0, last);
    }
  }
}


template <int VEC>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(scan_tile_kernel<VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

template <int VEC>
int blocks_per_sm() {
  int n = 0;
  if (allow_smem<VEC>() != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, scan_tile_kernel<VEC>, THREADS, SMEM_BYTES) != cudaSuccess) {
    return -1;
  }
  return n;
}


}  // namespace rht_scan

// -- kernel A′ --------------------------------------------------------------

namespace rht_ham {

using rht_l2::cp_async_commit;
using rht_l2::cp_async_wait;
using rht_scan::BUF_CAP;
using rht_scan::HEAP_AT;
using rht_scan::drain;
using rht_scan::empty_entry;
using rht_scan::heap_len;
using rht_scan::sift_down;

static_assert(BUF_CAP == 2 * TILE, "a buffer takes two tiles");

// The count limit of a query whose heap root is `root`: a row is
// admitted iff its count is below it. Strictly below: within a split the
// rows come in ascending id order, so every heap entry is an earlier row
// than the tile being filtered, and a row that ties the root (even a
// stale root, whose score only rises) ranks after it and after the
// split's final k-th entry. An empty heap (root -inf) admits every row.
__device__ __forceinline__ int count_limit(int2 root) {
  const float s = __int_as_float(root.x);
  return s == -CUDART_INF_F ? INT_MAX : (int)(-s);
}

template <class Core>
constexpr int smem_bytes() {
  // the word ring, a ring of bias rows, the query chunk, then per query
  // its popcount, key and append counter
  return STAGES * STAGE_WORDS * 4 + STAGES * TILE * 4 + Core::QS_BYTES +
         3 * TILE * 4;
}

// Block (query tile, split) selects, per query, the top k of its split's
// rows into the (split, query) slab, as kernel A does: its lists are
// kernel A's heaps, merged by list_merge_kernel.
template <class Core, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
    hamming_tile_kernel(const int* __restrict__ Q, const int* __restrict__ X,
                        const float* __restrict__ bias, int B, int N, int W,
                        int k, int ntiles, int tiles_per_split, int slab_len,
                        int2* __restrict__ slabs) {
  static_assert(Core::DRAIN_AT <= BUF_CAP - TILE, "a tile must fit");
  extern __shared__ __align__(16) unsigned char smem[];
  int* const ring = reinterpret_cast<int*>(smem);
  float* const bias_s = reinterpret_cast<float*>(ring + STAGES * STAGE_WORDS);
  unsigned char* const qs =
      reinterpret_cast<unsigned char*>(bias_s + STAGES * TILE);
  int* const popc_s = reinterpret_cast<int*>(qs + Core::QS_BYTES);
  int* const key_s = popc_s + TILE;
  int* const cnt_s = key_s + TILE;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TILE;
  const int split = blockIdx.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  const int nch = max(1, (W + WC - 1) / WC);
  const int total = max(0, t_end - t_begin) * nch;
  const bool own_live = q0 + tid < B;  // thread tid owns query q0 + tid
  int2* const slab0 = slabs + ((size_t)split * B + q0) * slab_len;
  int2* const heap = slab0 + (size_t)tid * slab_len + HEAP_AT;
  const int buf_at = heap_len(k);

  int popcq = 0;
  if (own_live) {
    for (int w = 0; w < W; ++w) popcq += __popc(Q[(size_t)(q0 + tid) * W + w]);
    for (int i = 0; i < k; ++i) heap[i] = empty_entry();
  }
  popc_s[tid] = popcq;
  key_s[tid] = own_live ? Core::key(popcq, INT_MAX) : Core::NEVER;
  cnt_s[tid] = 0;
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

  typename Core::Acc acc;
  Core::zero(acc);
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
      Core::stage(qs, Q, B, W, q0, w0, wn);
      __syncthreads();
    }
    Core::chunk(qs, ring + (u % STAGES) * STAGE_WORDS, wn, acc);
    if (part + 1 < nch) continue;

    // the tile is scored. First, if some buffer could not take another
    // tile, every owner merges its buffer (the counts are complete: the
    // barriers above came after the last tile's appends).
    if (__syncthreads_or(cnt_s[tid] > Core::DRAIN_AT)) {
      const int n = cnt_s[tid];
      if (n > 0) {
        key_s[tid] = Core::key(popcq, count_limit(drain(heap, k, n)));
        cnt_s[tid] = 0;
      }
      __syncthreads();
    }
    // then append every admitted live row to its query's buffer
    const int r0 = t * TILE;
    const float* const bias_t = bias_s + (t % STAGES) * TILE;
    Core::each(
        acc, key_s, cnt_s,
        [&](int rl) { return r0 + rl < N && bias_t[rl] != -CUDART_INF_F; },
        [&](int ql, int rl, int v, int slot) {
          const float s = __fsub_rn(
              bias_t[rl], __int2float_rn(Core::count(v, popc_s[ql])));
          slab0[(size_t)ql * slab_len + buf_at + slot] =
              make_int2(__float_as_int(s), r0 + rl);
        });
  }
  cp_async_wait<0>();  // no copy outlives the block (an empty split)
  __syncthreads();     // the last tile's appends are in
  if (own_live) {
    drain(heap, k, cnt_s[tid]);
    // heap-sort in place: the list g[0..k), best first
    for (int m = k - 1; m >= 1; --m) {
      const int2 last = heap[m];
      heap[m] = heap[0];
      heap[0] = sift_down(heap, m, 0, last);
    }
  }
}

template <class Core, int VEC>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(hamming_tile_kernel<Core, VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<Core>());
}

template <class Core, int VEC>
int blocks_per_sm() {
  int n = 0;
  if (allow_smem<Core, VEC>() != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, hamming_tile_kernel<Core, VEC>, THREADS, smem_bytes<Core>()) !=
      cudaSuccess) {
    return -1;
  }
  return n;
}

template <class Core>
int slots() {
  const int sms = rht_scan::card_sms();
  const int a = blocks_per_sm<Core, 4>();
  const int b = blocks_per_sm<Core, 1>();
  if (sms <= 0 || a <= 0 || b <= 0) return -1;
  return (a < b ? a : b) * sms;
}

template <class Core>
int launch(const int* q, const int* x, const float* bias, int B, int N, int W,
           int k, int splits, int2* slabs, float* out_s, int* out_i,
           cudaStream_t stream) {
  if (B <= 0 || k <= 0) return 0;
  const int ntiles = (N + TILE - 1) / TILE;
  if (N < 0 || W < 1 || splits < 1 || splits > (ntiles > 1 ? ntiles : 1) ||
      splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_per_split = (ntiles + splits - 1) / splits;
  const int slab_len = heap_len(k) + BUF_CAP;
  const dim3 grid((B + TILE - 1) / TILE, splits);
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err = vec4 ? allow_smem<Core, 4>() : allow_smem<Core, 1>();
  if (err != cudaSuccess) return (int)err;
  if (vec4) {
    hamming_tile_kernel<Core, 4><<<grid, THREADS, smem_bytes<Core>(), stream>>>(
        q, x, bias, B, N, W, k, ntiles, tiles_per_split, slab_len, slabs);
  } else {
    hamming_tile_kernel<Core, 1><<<grid, THREADS, smem_bytes<Core>(), stream>>>(
        q, x, bias, B, N, W, k, ntiles, tiles_per_split, slab_len, slabs);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return rht_scan::launch_merge(slabs, slab_len, B, k, splits, out_s, out_i,
                                stream);
}

}  // namespace rht_ham

// Resident blocks of kernel A's split kernel the current card holds at
// once (the fewer of its two forms), or a negative value on failure.
extern "C" int scan_topk_slots() {
  using namespace rht_scan;
  const int sms = card_sms();
  const int a = blocks_per_sm<4>();
  const int b = blocks_per_sm<1>();
  if (sms <= 0 || a <= 0 || b <= 0) return -1;
  return (a < b ? a : b) * sms;
}

// Entries (int2) of one (split, query) slab at selection width k, in
// kernels A and A′.
extern "C" int scan_topk_slab_len(int k) {
  return rht_scan::heap_len(k) + rht_scan::BUF_CAP;
}

// The split kernel's dynamic shared memory a block, in bytes.
extern "C" int scan_topk_smem_bytes() { return rht_scan::SMEM_BYTES; }

// slabs: [splits][B][scan_topk_slab_len(k)] int2 scratch.
extern "C" int scan_topk_launch(const float* q, const float* x,
                                const float* qq, const float* sq, int B,
                                int N, int D, int k, int splits,
                                int2* slabs, float* out_s, int* out_i,
                                cudaStream_t stream) {
  using namespace rht_scan;
  if (B <= 0 || k <= 0) return 0;
  const int ntiles = (N + TILE_R - 1) / TILE_R;
  if (N < 0 || splits < 1 || splits > (ntiles > 1 ? ntiles : 1) ||
      splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_per_split = (ntiles + splits - 1) / splits;
  const int slab_len = scan_topk_slab_len(k);
  const dim3 grid((B + TILE_Q - 1) / TILE_Q, splits);
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err = vec4 ? allow_smem<4>() : allow_smem<1>();
  if (err != cudaSuccess) return (int)err;
  if (vec4) {
    scan_tile_kernel<4><<<grid, THREADS, SMEM_BYTES, stream>>>(
        q, x, qq, sq, B, N, D, k, ntiles, tiles_per_split, slab_len, slabs);
  } else {
    scan_tile_kernel<1><<<grid, THREADS, SMEM_BYTES, stream>>>(
        q, x, qq, sq, B, N, D, k, ntiles, tiles_per_split, slab_len, slabs);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_merge(slabs, slab_len, B, k, splits, out_s, out_i, stream);
}

// Kernel A′'s resident blocks on the current card (the fewer of its two
// forms), or a negative value on failure.
extern "C" int scan_topk_hamming_slots() {
  return rht_ham::slots<rht_ham::MmaCore>();
}

// Kernel A′'s dynamic shared memory a block, in bytes.
extern "C" int scan_topk_hamming_smem_bytes() {
  return rht_ham::smem_bytes<rht_ham::MmaCore>();
}

// slabs: [splits][B][scan_topk_slab_len(k)] int2 scratch; bias is 0 on a
// live row and -inf on a dead one.
extern "C" int scan_topk_hamming_launch(const int* q, const int* x,
                                        const float* bias, int B, int N,
                                        int W, int k, int splits,
                                        int2* slabs, float* out_s, int* out_i,
                                        cudaStream_t stream) {
  return rht_ham::launch<rht_ham::MmaCore>(q, x, bias, B, N, W, k, splits,
                                           slabs, out_s, out_i, stream);
}
