// Kernels A-bf16 and A-int8: the selection of the bf16 and int8 scan tiers.
//
// The JAX package scores these tiers in XLA (redis_hnsw_tpu/ops/scan.py
// _chunk_scores, :157-171: a bf16 or int8 jnp.dot, then lax.top_k per
// chunk); no Pallas kernel of its stands behind them. Here they select
// on the tensor cores with kernel A's selection (scan_heap.cuh): per
// query, the top k rows of the table by score, best first, ties to the
// lowest row id, (-inf, -1) in empty slots.
//
//   A-bf16: dot = the bf16 x bf16 -> f32 product of the query's and the
//           row's bf16 copies (mma.sync m16n8k16),
//           score = __fsub_rn(__fsub_rn(__fmul_rn(2, dot), qq), sq)
//   A-int8: dot = the int8 x int8 -> int32 product of the per-row
//           quantized query and row (mma.sync m16n8k32, exact),
//           score = __fsub_rn(__fsub_rn(__fmul_rn(2, __fmul_rn(
//                     __int2float_rn(dot), __fmul_rn(qscale, tscale))),
//                     qq), sq)
//
// in the JAX package's order (scan.py:166-170). qq is the f32 queries'
// sqnorm and sq the f32 rows' (sq_masked: +inf on a dead row, which
// scores -inf and is never selected). |dot| <= 127^2 * D is exact in
// int32, and in f32 for D <= 1040, so A-int8's scores equal its plain
// version's bit for bit on any data. A-bf16's products are exact in f32;
// the tensor cores' sums round otherwise than a library matmul's, except
// where every partial sum is exact (integer data).
//
// Bound on the H100: 2*B*N*D tensor-core operations (0.54 ms in bf16 and
// 0.27 ms in int8 at B = 2048, N = 1,000,064, D = 128) against
// (B + N)*D*2 or *1 bytes; the selection's cycles are extra.
//
// Layout: kernel A′'s (scan_topk.cu hamming_tile_kernel). A block of 4
// warps scores a 128-query x 128-row tile; warp w takes rows 32w .. 32w +
// 31 against all 128 queries, 8 m16 query tiles x 4 n8 row tiles of mma
// products, 128 accumulators a thread. Both operands are rows of bytes (D
// x 2 for bf16, D x 1 for int8) and a k-step of either instruction is 32
// bytes, so the two cores differ only in the instruction and the score.
// The queries' and rows' bytes stream through a 3-stage cp.async ring of
// 128-byte chunks of each row (16-byte copies where a row is a multiple
// of 16 bytes and the operands are aligned, else 4-byte ones; the caller
// pads a row to 4 bytes), zeros past B, N and the row; a chunk's 16-byte
// segment s of row r sits at segment s ^ (r % 8), so every ldmatrix
// reads 32 distinct banks. Both fragments are read with ldmatrix.x4.
//
// Selection: kernel A′'s, on float keys. Thread q owns query q's heap.
// Each score is tested in registers against its query's key (shared
// memory), the heap root's score; a row is admitted strictly above it:
// within a split the rows come in ascending id order, so a row that ties
// the root (even a stale root, whose score only rises) ranks after it.
// An empty heap's key is -inf, which admits every live row; a query past
// B has +inf. A warp appends a query's survivors of its 32 rows with one
// shared atomic; once some buffer holds more than DRAIN_AT entries, every
// owner drains its buffer into its heap before a tile's appends. The
// heaps, drain, heap-sort and list_merge_kernel are kernel A's, so
// nothing bounds k but device memory; ops/cuda_scan.py plans the splits
// from each core's resident blocks. wgmma and TMA are left for later.
//
// C interface (ctypes, ops/cuda_scan.py): scan_lowp_launch,
// scan_lowp_slots and scan_lowp_smem_bytes, each taking the core (0 =
// bf16, 1 = int8); the launch returns cudaGetLastError().

#include "scan_heap.cuh"

namespace rht_lowp {

using rht_l2::cp_async;
using rht_l2::cp_async_commit;
using rht_l2::cp_async_wait;
using rht_scan::BUF_CAP;
using rht_scan::HEAP_AT;
using rht_scan::drain;
using rht_scan::empty_entry;
using rht_scan::heap_len;
using rht_scan::sift_down;

constexpr int TILE = 128;     // queries, and rows, per block tile
constexpr int THREADS = 128;  // one owned query per thread
constexpr int KB = 128;       // bytes of each row per ring stage
constexpr int KSTEP = 32;     // bytes of a row per mma k-step
constexpr int STAGES = 3;
constexpr int OPER_BYTES = TILE * KB;        // one operand's chunk
constexpr int STAGE_BYTES = 2 * OPER_BYTES;  // the queries', then the rows'
// a block drains its buffers before a tile's appends once one holds more
// than DRAIN_AT entries (at most BUF_CAP - TILE: a tile must fit)
constexpr int DRAIN_AT = 16;
// the ring, two rings of row operands (sq, tscale), then per query its
// qq, qscale, key and append counter
constexpr int SMEM_BYTES =
    STAGES * STAGE_BYTES + 2 * STAGES * TILE * 4 + 4 * TILE * 4;
constexpr unsigned FULL = 0xffffffffu;

static_assert(THREADS == TILE, "one owned query and one staged row a thread");
static_assert(BUF_CAP == 2 * TILE, "a buffer takes two tiles");
static_assert(DRAIN_AT <= BUF_CAP - TILE, "a tile must fit");

struct Bf16Core {
  using T = float;
  static constexpr bool SCALED = false;
  __device__ static void mma(float (&c)[4], const unsigned (&a)[4],
                             unsigned b0, unsigned b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static float score(float dot, float qn, float, float sn,
                                float) {
    return __fsub_rn(__fsub_rn(__fmul_rn(2.f, dot), qn), sn);
  }
  // an accumulator slot holding a score, and back
  __device__ static float put(float s) { return s; }
  __device__ static float get(float v) { return v; }
};

struct Int8Core {
  using T = int;
  static constexpr bool SCALED = true;
  __device__ static void mma(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                             unsigned b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static float score(int dot, float qn, float qsc, float sn,
                                float tsc) {
    const float dq = __fmul_rn(__int2float_rn(dot), __fmul_rn(qsc, tsc));
    return __fsub_rn(__fsub_rn(__fmul_rn(2.f, dq), qn), sn);
  }
  __device__ static int put(float s) { return __float_as_int(s); }
  __device__ static float get(int v) { return __int_as_float(v); }
};

// Start copying bytes [b0, b0 + KB) of operand rows r0 .. r0 + TILE - 1
// (row_bytes each, `rows` of them) into dst [TILE][KB], segment s of row r
// at segment s ^ (r % 8); zeros past the rows and past row_bytes. CP is
// the copy's bytes: 16 needs row_bytes % 16 == 0 and an aligned operand,
// 4 needs row_bytes % 4 == 0 and 4-byte alignment, so a copy is wholly
// inside or wholly outside a row.
template <int CP>
__device__ __forceinline__ void load_operand(unsigned char* dst,
                                             const unsigned char* __restrict__
                                                 src,
                                             int rows, int row_bytes, int r0,
                                             int b0) {
  constexpr int PER_ROW = KB / CP;
  constexpr int ROWS_PER_PASS = THREADS / PER_ROW;
  const int col = threadIdx.x % PER_ROW;
  const int b = b0 + col * CP;
  const int seg = col * CP / 16;
  const int within = col * CP % 16;
#pragma unroll
  for (int p = 0; p < TILE / ROWS_PER_PASS; ++p) {
    const int r = threadIdx.x / PER_ROW + p * ROWS_PER_PASS;
    const bool ok = r0 + r < rows && b < row_bytes;
    cp_async<CP / 4>(
        reinterpret_cast<float*>(dst + r * KB + ((seg ^ (r & 7)) << 4) +
                                 within),
        reinterpret_cast<const float*>(
            ok ? src + (size_t)(r0 + r) * row_bytes + b : src),
        ok ? CP : 0);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// acc += the products of one ring stage's query and row chunks over its
// first `steps` k-steps. Element e of tile (m, n) is query 16m + g + 8(e /
// 2) and row 32 warp + 8n + 2 tig + e % 2 (g = lane / 4, tig = lane % 4).
template <class Core>
__device__ __forceinline__ void mma_chunk(const unsigned char* stage,
                                          int steps,
                                          typename Core::T (&acc)[8][4][4]) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned qbase = (unsigned)__cvta_generic_to_shared(stage);
  const unsigned xbase = qbase + OPER_BYTES;
  // A (queries): lanes 8i .. 8i + 7 address matrix i, rows (i & 1) * 8 ..
  // + 7 of a 16-query tile and 16-byte half i >> 1 of the k-step: the
  // registers a0 .. a3 of the m16 fragment
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int ah = lane >> 4;
  // B (rows): matrix i is n tile 2p + (i >> 1), half i & 1: b0, b1 of the
  // pair's two n8 fragments
  const int br = warp * 32 + (lane >> 4) * 8 + (lane & 7);
  const int bh = (lane >> 3) & 1;
  const int sw = lane & 7;  // row % 8 of every row this lane addresses
#pragma unroll
  for (int s = 0; s < KB / KSTEP; ++s) {
    if (s >= steps) break;
    unsigned a[8][4];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      ldmatrix_x4(a[m], qbase + (ar + 16 * m) * KB +
                            (((2 * s + ah) ^ sw) << 4));
    }
    unsigned b[2][4];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      ldmatrix_x4(b[p], xbase + (br + 16 * p) * KB +
                            (((2 * s + bh) ^ sw) << 4));
    }
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        Core::mma(acc[m][n], a[m], b[n >> 1][2 * (n & 1)],
                  b[n >> 1][2 * (n & 1) + 1]);
      }
  }
}

// Score the finished tile (rows r0 ..) and append every row that beats
// its query's key to the query's buffer; zeroes the accumulators. The 4
// lanes 4g .. 4g + 3 hold a query's 32 rows of the warp: for each (m, h),
// query 16m + g + 8h. Each lane scores its 8 rows into a mask (the score
// goes back into its accumulator), the 4 lanes prefix-sum their survivor
// counts by shuffles, one of them reserves the slots with one shared
// atomic, and each lane writes its survivors. G (m, h) pairs go through
// these steps side by side behind one warp vote: survivors are rare once
// the heaps fill.
template <class Core, int G = 4>
__device__ __forceinline__ void admit(typename Core::T (&acc)[8][4][4],
                                      int r0, int N, const float* sq_t,
                                      const float* ts_t, const float* qq_s,
                                      const float* qs_s, const float* key_s,
                                      int* cnt_s, int2* slab0, int slab_len,
                                      int buf_at) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int row0 = warp * 32 + 2 * tig;  // bit j of a mask: + 8(j/2) + j%2
  float sn[8], ts[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int rl = row0 + 8 * (j / 2) + j % 2;
    sn[j] = r0 + rl < N ? sq_t[rl] : CUDART_INF_F;  // rows >= N: -inf
    ts[j] = Core::SCALED ? ts_t[rl] : 0.f;
  }
#pragma unroll
  for (int mh0 = 0; mh0 < 16; mh0 += G) {
    unsigned mask[G];
    unsigned any = 0;
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int m = (mh0 + u) / 2, h = (mh0 + u) % 2;
      const int ql = 16 * m + g + 8 * h;
      const float key = key_s[ql];
      const float qn = qq_s[ql];
      const float qsc = Core::SCALED ? qs_s[ql] : 0.f;
      unsigned mk = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        auto& v = acc[m][j / 2][2 * h + j % 2];
        const float s = Core::score(v, qn, qsc, sn[j], ts[j]);
        v = Core::put(s);
        mk |= (unsigned)(s > key) << j;
      }
      mask[u] = mk;
      any |= mk;
    }
    if (!__any_sync(FULL, any)) continue;
    int cnt[G], incl[G];  // incl: inclusive prefix over the 4 lanes
#pragma unroll
    for (int u = 0; u < G; ++u) incl[u] = cnt[u] = __popc(mask[u]);
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int up = __shfl_up_sync(FULL, incl[u], 1, 4);
      if (tig >= 1) incl[u] += up;
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int up = __shfl_up_sync(FULL, incl[u], 2, 4);
      if (tig >= 2) incl[u] += up;
    }
    int slot[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int ql = 16 * ((mh0 + u) / 2) + g + 8 * ((mh0 + u) % 2);
      slot[u] = 0;
      if (tig == 3 && incl[u] > 0) slot[u] = atomicAdd(&cnt_s[ql], incl[u]);
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      slot[u] = __shfl_sync(FULL, slot[u], 3, 4) + incl[u] - cnt[u];
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int m = (mh0 + u) / 2, h = (mh0 + u) % 2;
      const int ql = 16 * m + g + 8 * h;
      for (unsigned bits = mask[u]; bits; bits &= bits - 1) {
        const int j = __ffs(bits) - 1;
        typename Core::T v = acc[m][0][2 * h];
#pragma unroll
        for (int w = 1; w < 8; ++w) {
          v = j == w ? acc[m][w / 2][2 * h + w % 2] : v;
        }
        slab0[(size_t)ql * slab_len + buf_at + slot[u]++] = make_int2(
            __float_as_int(Core::get(v)), r0 + row0 + 8 * (j / 2) + j % 2);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;
}

// Block (query tile, split) selects, per query, the top k of its split's
// rows into the (split, query) slab, as kernel A does: its lists are
// kernel A's heaps, merged by list_merge_kernel.
template <class Core, int CP>
__global__ void __launch_bounds__(THREADS, 2)
    lowp_tile_kernel(const unsigned char* __restrict__ Q,
                     const unsigned char* __restrict__ X,
                     const float* __restrict__ qq,
                     const float* __restrict__ qscale,
                     const float* __restrict__ sq,
                     const float* __restrict__ tscale, int B, int N,
                     int row_bytes, int k, int ntiles, int tiles_per_split,
                     int slab_len, int2* __restrict__ slabs) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const ring = smem;
  float* const sq_s = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  float* const ts_s = sq_s + STAGES * TILE;  // tile t's at t % STAGES
  float* const qq_s = ts_s + STAGES * TILE;
  float* const qs_s = qq_s + TILE;
  float* const key_s = qs_s + TILE;
  int* const cnt_s = reinterpret_cast<int*>(key_s + TILE);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TILE;
  const int split = blockIdx.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  const int kch = max(1, (row_bytes + KB - 1) / KB);
  const int total = max(0, t_end - t_begin) * kch;
  const bool own_live = q0 + tid < B;  // thread tid owns query q0 + tid
  int2* const slab0 = slabs + ((size_t)split * B + q0) * slab_len;
  int2* const heap = slab0 + (size_t)tid * slab_len + HEAP_AT;
  const int buf_at = heap_len(k);

  if (own_live) {
    for (int i = 0; i < k; ++i) heap[i] = empty_entry();
  }
  qq_s[tid] = own_live ? qq[q0 + tid] : 0.f;
  qs_s[tid] = own_live && Core::SCALED ? qscale[q0 + tid] : 0.f;
  key_s[tid] = own_live ? -CUDART_INF_F : CUDART_INF_F;
  cnt_s[tid] = 0;
  // the loop's first barrier orders these before any read

  auto load = [&](int u) {
    const int t = t_begin + u / kch;
    const int part = u % kch;
    unsigned char* const st = ring + (u % STAGES) * STAGE_BYTES;
    load_operand<CP>(st, Q, B, row_bytes, q0, part * KB);
    load_operand<CP>(st + OPER_BYTES, X, N, row_bytes, t * TILE, part * KB);
    if (part == 0) {
      const int r = t * TILE + tid;
      cp_async<1>(sq_s + (t % STAGES) * TILE + tid, r < N ? sq + r : sq,
                  r < N ? 4 : 0);
      if (Core::SCALED) {
        cp_async<1>(ts_s + (t % STAGES) * TILE + tid,
                    r < N ? tscale + r : tscale, r < N ? 4 : 0);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }

  typename Core::T acc[8][4][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;
  for (int u = 0; u < total; ++u) {
    const int t = t_begin + u / kch;
    const int part = u % kch;
    cp_async_wait<STAGES - 2>();  // unit u has landed (this thread's part)
    __syncthreads();  // ... everyone's; and unit u - 1's slot is free
    if (u + STAGES - 1 < total) load(u + STAGES - 1);
    cp_async_commit();
    const int steps = min(KB, row_bytes - part * KB + KSTEP - 1) / KSTEP;
    mma_chunk<Core>(ring + (u % STAGES) * STAGE_BYTES, steps, acc);
    if (part + 1 < kch) continue;

    // the tile is scored. First, once some buffer holds more than
    // DRAIN_AT entries, every owner drains its buffer (the counts are
    // complete: the barriers above came after the last tile's appends).
    if (__syncthreads_or(cnt_s[tid] > DRAIN_AT)) {
      const int n = cnt_s[tid];
      if (n > 0) {
        key_s[tid] = __int_as_float(drain(heap, k, n).x);
        cnt_s[tid] = 0;
      }
      __syncthreads();
    }
    admit<Core>(acc, t * TILE, N, sq_s + (t % STAGES) * TILE,
                ts_s + (t % STAGES) * TILE, qq_s, qs_s, key_s, cnt_s, slab0,
                slab_len, buf_at);
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

template <class Core, int CP>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(lowp_tile_kernel<Core, CP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

template <class Core, int CP>
int blocks_per_sm() {
  int n = 0;
  if (allow_smem<Core, CP>() != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, lowp_tile_kernel<Core, CP>, THREADS, SMEM_BYTES) !=
      cudaSuccess) {
    return -1;
  }
  return n;
}

template <class Core>
int slots() {
  const int sms = rht_scan::card_sms();
  const int a = blocks_per_sm<Core, 16>();
  const int b = blocks_per_sm<Core, 4>();
  if (sms <= 0 || a <= 0 || b <= 0) return -1;
  return (a < b ? a : b) * sms;
}

template <class Core>
int launch(const unsigned char* q, const unsigned char* x, const float* qq,
           const float* qscale, const float* sq, const float* tscale, int B,
           int N, int row_bytes, int k, int splits, int2* slabs,
           float* out_s, int* out_i, cudaStream_t stream) {
  if (B <= 0 || k <= 0) return 0;
  const int ntiles = (N + TILE - 1) / TILE;
  const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (N < 0 || row_bytes < 4 || row_bytes % 4 != 0 || qa % 4 != 0 ||
      xa % 4 != 0 || splits < 1 || splits > (ntiles > 1 ? ntiles : 1) ||
      splits > 65535 || (Core::SCALED && (!qscale || !tscale))) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_per_split = (ntiles + splits - 1) / splits;
  const int slab_len = heap_len(k) + BUF_CAP;
  const dim3 grid((B + TILE - 1) / TILE, splits);
  const bool vec16 = row_bytes % 16 == 0 && qa % 16 == 0 && xa % 16 == 0;
  cudaError_t err =
      vec16 ? allow_smem<Core, 16>() : allow_smem<Core, 4>();
  if (err != cudaSuccess) return (int)err;
  if (vec16) {
    lowp_tile_kernel<Core, 16><<<grid, THREADS, SMEM_BYTES, stream>>>(
        q, x, qq, qscale, sq, tscale, B, N, row_bytes, k, ntiles,
        tiles_per_split, slab_len, slabs);
  } else {
    lowp_tile_kernel<Core, 4><<<grid, THREADS, SMEM_BYTES, stream>>>(
        q, x, qq, qscale, sq, tscale, B, N, row_bytes, k, ntiles,
        tiles_per_split, slab_len, slabs);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return rht_scan::launch_merge(slabs, slab_len, B, k, splits, out_s, out_i,
                                stream);
}

}  // namespace rht_lowp

// Resident blocks of core `core` (0 = bf16, 1 = int8) on the current card
// (the fewer of its two copy forms), or a negative value on failure.
extern "C" int scan_lowp_slots(int core) {
  return core == 0 ? rht_lowp::slots<rht_lowp::Bf16Core>()
                   : rht_lowp::slots<rht_lowp::Int8Core>();
}

// A block's dynamic shared memory, in bytes (both cores).
extern "C" int scan_lowp_smem_bytes() { return rht_lowp::SMEM_BYTES; }

// q [B][row_bytes] and x [N][row_bytes] bytes (bf16 or int8 rows, each
// row a multiple of 4 bytes); qscale and tscale only for int8 (core 1).
// slabs: [splits][B][scan_topk_slab_len(k)] int2 scratch.
extern "C" int scan_lowp_launch(int core, const void* q, const void* x,
                                const float* qq, const float* qscale,
                                const float* sq, const float* tscale, int B,
                                int N, int row_bytes, int k, int splits,
                                int2* slabs, float* out_s, int* out_i,
                                cudaStream_t stream) {
  const auto* qb = static_cast<const unsigned char*>(q);
  const auto* xb = static_cast<const unsigned char*>(x);
  if (core == 0) {
    return rht_lowp::launch<rht_lowp::Bf16Core>(qb, xb, qq, qscale, sq,
                                                tscale, B, N, row_bytes, k,
                                                splits, slabs, out_s, out_i,
                                                stream);
  }
  if (core == 1) {
    return rht_lowp::launch<rht_lowp::Int8Core>(qb, xb, qq, qscale, sq,
                                                tscale, B, N, row_bytes, k,
                                                splits, slabs, out_s, out_i,
                                                stream);
  }
  return (int)cudaErrorInvalidValue;
}
