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
//   Scores. Bit-identical to score.cuh's routine, which kernel B (the
//   two-pass certificate's count) shares, and to kernel D's core:
//     dot   = one __fmaf_rn chain over d = 0 .. D-1 in order, from +0
//     score = __fsub_rn(__fsub_rn(__fmul_rn(2, dot), qq), sq)
//   No tensor cores, no TF32, no split-K, no reassociation. Dims past D
//   are staged as zeros, and fma(0, 0, dot) == dot for every dot the
//   chain can produce (it never holds -0).
//
//   Bound on the H100: 2*B*N*D fp32 operations against (B + N)*D*4 bytes,
//   compute-bound at every serving shape (7.8 ms at B = 2048, N = 1M,
//   D = 128). So the scoring core is kernel D's (select_bins.cu, a copy
//   kept here so that D's source stays as it was measured): a block
//   scores a 128-query x 128-row tile with 128 threads, each holding an
//   8 x 16 fp32 register tile (queries ty + 16i, i < 8, and rows tx + 8j,
//   j < 16; tx = tid % 8, ty = tid / 8), 32 FMAs per 16-byte shared load;
//   operands stream through a 3-stage cp.async ring of 32-dim chunks
//   that runs on across row tiles (16-byte copies; a 4-byte-copy instance
//   when D % 4 != 0 or an operand is not 16-byte aligned).
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
// Kernel A' (hamming; topk_split_kernel<HammingScorer>, topk_merge_kernel)
// -- the exact hamming tier. A' is bound by its B*N*W popcounts (16 per
// clock per SM) against (B + N)*W*4 bytes. Its design is the first one:
// block (64-query tile, split) scores through score.cuh's hamming_tile
// (4 x 4 register tiles), stores the tile in shared memory, and one warp
// per query inserts what beats its list's k-th entry into a sorted list
// in shared memory (ballot for the position, shift, write); k <= 256,
// splits <= 32 (one merge lane each).
//
// C interface (ctypes, ops/cuda_scan.py): scan_topk_launch (A),
// scan_topk_slots, scan_topk_slab_len, scan_topk_smem_bytes, and
// scan_topk_hamming_launch (A'); the launches return cudaGetLastError().

#include <cfloat>
#include <climits>
#include <cstdint>

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

// -- kernel A -------------------------------------------------------------

namespace rht_scan {

constexpr int TILE_R = 128;   // rows per block tile
constexpr int TILE_Q = 128;   // queries per block tile
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
// entries of a (split, query) append buffer: a tile adds at most TILE_R,
// and the block merges before a tile once any buffer holds BUF_CAP -
// TILE_R or more, so no tile overflows one (the first merge comes after
// the first tile)
constexpr int BUF_CAP = 2 * TILE_R;
constexpr int WARPS = THREADS / 32;
// the operand ring, the tile's query norms and a ring of row norms
// (floats), then the queries' thresholds (floats), append counters and
// the warps' merge votes
constexpr int RING_FLOATS = STAGES * STAGE_FLOATS + TILE_Q + STAGES * TILE_R;
constexpr int SMEM_BYTES = RING_FLOATS * (int)sizeof(float) +
                           TILE_Q * (int)(sizeof(float) + sizeof(int)) +
                           WARPS * (int)sizeof(int);
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MERGE_WARPS = 4;

static_assert(TQ * MQ == TILE_Q && TR * MR == TILE_R, "tile");
static_assert(TQ * TR == THREADS, "one register tile per thread");
static_assert(THREADS == TILE_Q && THREADS == TILE_R, "one norm per thread");
static_assert(WARPS == 4, "a tile's votes are one int4");

// Entries of one (split, query) slab: an ARITY-ary heap g[0..k) at slab
// offset HEAP_AT, then the append buffer. Node i's children g[8i + 1 ..
// 8i + 8] sit at slab offset 8(i + 1), four aligned 16-byte loads (a slab
// is a multiple of 8 entries); the heap region covers every child slot
// that a sift reads.
constexpr int ARITY = 8;
constexpr int HEAP_AT = ARITY - 1;
__host__ __device__ __forceinline__ int heap_len(int k) {
  return (k + HEAP_AT + 2 * ARITY - 1) & ~(ARITY - 1);
}

// An entry: a score's bits and its row id.
__device__ __forceinline__ bool beats(int2 a, int2 b) {
  const float as = __int_as_float(a.x), bs = __int_as_float(b.x);
  return as > bs || (as == bs && a.y < b.y);
}

// An empty heap slot: every real row beats it.
__device__ __forceinline__ int2 empty_entry() {
  return make_int2(__float_as_int(-CUDART_INF_F), -1);
}

// A query's admission threshold from its heap's root: a score enters the
// buffer iff score >= threshold. Ties at the root's score are admitted
// and settled by id in the heap; -FLT_MAX keeps dead rows (-inf) out of
// an empty heap.
__device__ __forceinline__ float threshold(int2 root) {
  return fmaxf(__int_as_float(root.x), -FLT_MAX);
}

// In the heap every node beats or equals its parent, so the root is the
// worst entry. Sift c down from node i of g[0..n): returns the entry that
// node i then holds and writes the nodes below it (not node i itself, so
// the caller may keep it in a register).
__device__ __forceinline__ int2 sift_down(int2* g, int n, int i, int2 c) {
  int2 top = c;
  int cur = i;
  for (;;) {
    const int c1 = ARITY * cur + 1;
    if (c1 >= n) break;
    const int4* p = reinterpret_cast<const int4*>(g + c1);
    const int4 v[ARITY / 2] = {p[0], p[1], p[2], p[3]};
    int2 w = make_int2(v[0].x, v[0].y);
    int wi = c1;
#pragma unroll
    for (int u = 1; u < ARITY; ++u) {
      const int2 e = u % 2 ? make_int2(v[u / 2].z, v[u / 2].w)
                           : make_int2(v[u / 2].x, v[u / 2].y);
      if (c1 + u < n && beats(w, e)) {
        w = e;
        wi = c1 + u;
      }
    }
    if (!beats(c, w)) break;
    if (cur == i) {
      top = w;
    } else {
      g[cur] = w;
    }
    cur = wi;
  }
  if (cur != i) g[cur] = c;
  return top;
}

// The owner lane's merge of its buffer (n entries) into its heap g (k
// entries): every buffered entry that beats the root replaces it. The
// root and its ARITY children are held in registers meanwhile, so an
// insertion reads device memory only below them (none for k <= 9, one
// level of loads for k <= 73). Returns the new root. The buffer is read
// DRAIN_BATCH entries at a time, so the loads overlap.
constexpr int DRAIN_BATCH = 4;
__device__ __forceinline__ int2 drain(int2* g, int k, int n) {
  const int2* buf = g - HEAP_AT + heap_len(k);
  const int n1 = min(k - 1, ARITY);  // children of the root: g[1..n1]
  int2 root = g[0];
  int2 l1[ARITY];
  {
    const int4* p = reinterpret_cast<const int4*>(g + 1);
#pragma unroll
    for (int u = 0; u < ARITY / 2; ++u) {
      const int4 v = p[u];
      l1[2 * u] = make_int2(v.x, v.y);
      l1[2 * u + 1] = make_int2(v.z, v.w);
    }
  }
  for (int e0 = 0; e0 < n; e0 += DRAIN_BATCH) {
    int2 cb[DRAIN_BATCH];
#pragma unroll
    for (int u = 0; u < DRAIN_BATCH; ++u) {
      // written by other lanes of the warp: read past the SM's L1
      cb[u] = e0 + u < n ? __ldcg(buf + e0 + u) : empty_entry();
    }
#pragma unroll
    for (int u = 0; u < DRAIN_BATCH; ++u) {
      const int2 c = cb[u];
      if (!beats(c, root)) continue;
      int2 w = l1[0];
      int wi = 0;
#pragma unroll
      for (int v = 1; v < ARITY; ++v) {
        if (v < n1 && beats(w, l1[v])) {
          w = l1[v];
          wi = v;
        }
      }
      if (n1 == 0 || !beats(c, w)) {
        root = c;
        continue;
      }
      root = w;
      const int2 top = sift_down(g, k, 1 + wi, c);
#pragma unroll
      for (int v = 0; v < ARITY; ++v) {
        if (v == wi) l1[v] = top;
      }
    }
  }
  g[0] = root;
#pragma unroll
  for (int v = 0; v < ARITY; ++v) {
    if (v < n1) g[1 + v] = l1[v];
  }
  return root;
}

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
        const float s =
            __fsub_rn(__fsub_rn(__fmul_rn(2.f, acc[i][j]), qn), sn[j]);
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

// Per query, the best k of the `splits` sorted lists g[0..k) of its
// slabs, (-inf, -1) past the last real entry.
__global__ void __launch_bounds__(32 * MERGE_WARPS)
    list_merge_kernel(const int2* __restrict__ slabs, int slab_len, int B,
                      int k, int splits, float* __restrict__ out_s,
                      int* __restrict__ out_i) {
  extern __shared__ int next_s[];  // [MERGE_WARPS][splits]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.x * MERGE_WARPS + warp;
  if (q >= B) return;  // whole warps only; no block barrier below
  int* const next = next_s + warp * splits;
  for (int l = lane; l < splits; l += 32) next[l] = 0;
  __syncwarp();
  const int2* const lists = slabs + (size_t)q * slab_len + HEAP_AT;
  const size_t stride = (size_t)B * slab_len;
  // this lane's best head over lists lane, lane + 32, ...
  auto rescan = [&](int2& best, int& bl) {
    best = empty_entry();
    bl = -1;
    for (int l = lane; l < splits; l += 32) {
      const int p = next[l];
      if (p >= k) continue;
      const int2 e = lists[l * stride + p];
      if (bl < 0 || beats(e, best)) {
        best = e;
        bl = l;
      }
    }
  };
  int2 head;
  int hl;
  rescan(head, hl);
  for (int j = 0; j < k; ++j) {
    int2 b = head;
    int wl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int2 o = make_int2(__shfl_xor_sync(FULL_MASK, b.x, off),
                               __shfl_xor_sync(FULL_MASK, b.y, off));
      const int ol = __shfl_xor_sync(FULL_MASK, wl, off);
      if (beats(o, b) || (!beats(b, o) && ol < wl)) {
        b = o;
        wl = ol;
      }
    }
    const float bs = __int_as_float(b.x);
    const bool valid = bs > -CUDART_INF_F;
    if (lane == 0) {
      out_s[(size_t)q * k + j] = valid ? bs : -CUDART_INF_F;
      out_i[(size_t)q * k + j] = valid ? b.y : -1;
    }
    if (!valid) {
      // every list is spent: pad the rest of the row
      for (int jj = j + 1 + lane; jj < k; jj += 32) {
        out_s[(size_t)q * k + jj] = -CUDART_INF_F;
        out_i[(size_t)q * k + jj] = -1;
      }
      break;
    }
    if (lane == wl) {
      ++next[hl];
      rescan(head, hl);
    }
    __syncwarp();
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

// Resident blocks of kernel A's split kernel the current card holds at
// once (the fewer of its two forms), or a negative value on failure.
extern "C" int scan_topk_slots() {
  using namespace rht_scan;
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

// Entries (int2) of one (split, query) slab at selection width k.
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
  const int merge_smem = MERGE_WARPS * splits * (int)sizeof(int);
  if (merge_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(list_merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               merge_smem);
    if (err != cudaSuccess) return (int)err;
  }
  list_merge_kernel<<<(B + MERGE_WARPS - 1) / MERGE_WARPS, 32 * MERGE_WARPS,
                      merge_smem, stream>>>(slabs, slab_len, B, k, splits,
                                            out_s, out_i);
  return (int)cudaGetLastError();
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
