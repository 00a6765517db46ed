// What the warpgroup-MMA forms of kernels A-int8 (scan_int8.cu) and A-bf16
// (scan_bf16.cu) share. The Hopper PTX: mbarriers, tensor copies (TMA),
// the wgmma operand descriptor, wgmma's fence / commit / wait, named
// barriers over one warpgroup; on the host, tensor maps made through the
// driver's cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
// And the frame of their kernel (Frame, Scan, Launch below): a block's
// geometry and shared memory, the producer's copies, the consumers' tile
// loop, kernel A's selection around it (scan_heap.cuh) and the launch's
// checks and merge. Each form keeps its wgmma instruction, its row terms
// and its score epilogue.

#pragma once

#include <cstdint>
#include <initializer_list>

#include <cuda.h>
#include <cuda_runtime.h>

#include "scan_heap.cuh"

// The kernels' parts are lambdas over their state; each is inlined, so the
// accumulators stay in registers.
#define RHT_INLINE __attribute__((always_inline))

namespace rht_hopper {

// -- PTX: mbarriers, tensor copies, warpgroup MMA, named barriers ---------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of parity `parity` to complete; a copy that never
// lands traps after 2^24 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (polls == (1u << 24)) __trap();
  }
}

// The box of `map` at (byte x, row y) to shared dst (1024-byte aligned),
// completing on bar's transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

// The box of 1-D `map` at element x to shared dst (16-byte aligned).
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            int x, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2}], [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(smem_u32(bar))
      : "memory");
}

// A wgmma operand descriptor: K-major rows of 128 bytes in the 128-byte
// swizzle, 8-row groups 1024 bytes apart, starting at shared address
// `addr` (a k-step of 32 bytes adds 32 to it).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barrier `id` over one warpgroup; and the same barrier with an OR
// of `pred` over its threads.
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ bool wg_any(int id, bool pred) {
  int r;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.b32 q, %1, 0;\n\t"
      "bar.red.or.pred p, %2, 128, q;\n\t"
      "selp.s32 %0, 1, 0, p;\n\t}"
      : "=r"(r)
      : "r"((int)pred), "r"(id)
      : "memory");
  return r != 0;
}

// -- host side: tensor maps -------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found once through the runtime.
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &got) != cudaSuccess ||
        got != cudaDriverEntryPointSuccess) {
      return (EncodeTiled) nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map of a [rows, row_bytes] byte table: box_rows x 128-byte
// boxes in the 128-byte swizzle, zeros past the table. Made per launch
// (a table moves with each snapshot epoch, the queries with each call).
inline bool byte_map(const void* base, int rows, int row_bytes, int box_rows,
                     CUtensorMap* out) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes,
                              (cuuint64_t)(rows > 0 ? rows : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(out, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map of an [n] float vector: box_n-element boxes, zeros past it.
inline bool float_map(const float* base, int n, int box_n, CUtensorMap* out) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)(n > 0 ? n : 1)};
  const cuuint64_t strides[1] = {4};  // (none for one dimension)
  const cuuint32_t box[1] = {(cuuint32_t)box_n};
  const cuuint32_t unit[1] = {1};
  return encode(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                const_cast<float*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether a tensor map takes these operands: rows a multiple of 16 bytes
// and every base on a 16-byte boundary.
inline bool map_takes(int row_bytes, std::initializer_list<const void*> ptrs) {
  if (row_bytes <= 0 || row_bytes % 16 != 0) return false;
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

// -- the frame of the wgmma scan forms ---------------------------------------

using rht_scan::admission_key;
using rht_scan::BUF_CAP;
using rht_scan::drain;
using rht_scan::empty_entry;
using rht_scan::HEAP_AT;
using rht_scan::heap_len;
using rht_scan::key_dec;
using rht_scan::key_enc;
using rht_scan::sift_down;

// Phases of a consumer warp, then of the producer warp, that a study's
// probe times; and the counts it keeps.
enum {
  P_SETUP,
  P_FULL_WAIT,   // waiting for a chunk's copy
  P_ROWS,        // the tile's row terms
  P_MMA,         // issuing wgmma, waiting for it
  P_DRAIN,       // the drain vote and drains
  P_COMPARE,     // the epilogue's common case and the warp's vote
  P_ADMIT,       // the rows past it scored exactly, appends
  P_LAST,        // the last drain and the heap sort
  P_EMPTY_WAIT,  // producer: waiting for a free stage
  P_ISSUE,       // producer: issuing copies
  PHASES
};
// warp epilogues, those that took the admission path, values past a
// filter, rows admitted
enum { C_EPILOGUES, C_SLOW, C_PASSED, C_ADMITTED, COUNTS };

struct NoProbe {
  static constexpr bool COUNTING = false;
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void count(int, int) {}
  __device__ void finish() {}
};

// A block's geometry: CWG_ consumer warpgroups of 64 queries each and a
// producer warpgroup; a ring of STAGES_ chunks of 128 rows x 128 bytes of
// the [N, row_bytes] table (the 128-byte swizzle span), each with the
// block's query chunk beside it for rows too wide to keep the queries
// resident, and on a tile's first chunk VECS_ per-row f32 vectors of the
// tile (sq; tscale too for int8); CORE_BYTES of shared memory for the
// form's own buffers.
template <int CWG_, int STAGES_, int VECS_, int CORE_BYTES>
struct Frame {
  static constexpr int CWG = CWG_;
  static constexpr int STAGES = STAGES_;
  static constexpr int VECS = VECS_;
  static constexpr int TILE_Q = 64 * CWG;   // queries a block
  static constexpr int TILE_N = 128;        // rows a tile: the wgmma's n
  static constexpr int KB = 128;            // bytes of a row a chunk
  static constexpr int KSTEP = 32;          // bytes of a row a wgmma k-step
  static constexpr int CHUNK = TILE_N * KB;   // 16 KB: a chunk of rows
  static constexpr int QCHUNK = TILE_Q * KB;  // a chunk of the queries
  static constexpr int QRES_CHUNKS = 8;  // resident queries: rows <= 1024 B
  static constexpr int WG = 128;         // threads a warpgroup
  static constexpr int THREADS = (CWG + 1) * WG;  // consumers + producer
  // registers a thread: the producer gives its own to the consumers
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS =
      (65536 / WG - PRODUCER_REGS) / CWG / 8 * 8 > 232
          ? 232
          : (65536 / WG - PRODUCER_REGS) / CWG / 8 * 8;
  static constexpr int ACC = TILE_N / 2;  // accumulators a thread
  // shared memory: barriers; key and count per query; each stage's
  // vectors; the form's own buffers; the operands from HDR
  static constexpr int KEY_AT = 128;
  static constexpr int CNT_AT = KEY_AT + TILE_Q * 4;
  static constexpr int VEC_AT = CNT_AT + TILE_Q * 4;
  static constexpr int CORE_AT = VEC_AT + STAGES * VECS * TILE_N * 4;
  static constexpr int HDR = (CORE_AT + CORE_BYTES + 1023) / 1024 * 1024;
  static_assert((2 * STAGES + 1) * 8 <= KEY_AT, "the barriers fit");
  static_assert(VEC_AT % 16 == 0, "a 1-D tensor copy lands on 16 bytes");
  static_assert(BUF_CAP == 2 * TILE_N, "a buffer takes two tiles");

  __host__ __device__ static constexpr int chunks(int row_bytes) {
    return (row_bytes + KB - 1) / KB;
  }
  __host__ __device__ static constexpr bool resident(int row_bytes) {
    return chunks(row_bytes) <= QRES_CHUNKS;
  }
  // dynamic shared memory of a block (1024 bytes of it for alignment)
  __host__ __device__ static constexpr int smem_bytes(int row_bytes) {
    return 1024 + HDR +
           (resident(row_bytes) ? chunks(row_bytes) * QCHUNK + STAGES * CHUNK
                                : STAGES * (CHUNK + QCHUNK));
  }
};

// After a wait: the accumulators are read only from here on.
__device__ __forceinline__ void acc_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void acc_fence(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// acc[4 (i / 2) + 2h + i % 2] for 0 <= i < 32, selected by i's bits (an
// index into a register array would put it in local memory).
template <class T>
__device__ __forceinline__ T acc_pick(const T (&acc)[64], int h, int i) {
  T l0[16], l1[8], l2[4], l3[2];
#pragma unroll
  for (int x = 0; x < 16; ++x) {
    l0[x] = i & 1 ? acc[4 * x + 2 * h + 1] : acc[4 * x + 2 * h];
  }
#pragma unroll
  for (int x = 0; x < 8; ++x) l1[x] = i & 2 ? l0[2 * x + 1] : l0[2 * x];
#pragma unroll
  for (int x = 0; x < 4; ++x) l2[x] = i & 4 ? l1[2 * x + 1] : l1[2 * x];
#pragma unroll
  for (int x = 0; x < 2; ++x) l3[x] = i & 8 ? l2[2 * x + 1] : l2[2 * x];
  return i & 16 ? l3[1] : l3[0];
}

// A block of a wgmma form, F's geometry: block (query tile, split) selects,
// per query, the top k of its split's rows into the (split, query) slab,
// with kernel A's heaps (scan_heap.cuh). Threads 0..63 of consumer
// warpgroup wg own queries 64 wg + tw: their heaps, keys and append
// counts. A consumer thread (warp w of warpgroup wg, lane 4g + tig) holds
// queries qb[h] = 64 wg + 16 w + g + 8h against rows 8j + 2 tig + e of
// each tile (the m64n128 accumulator layout), so their keys live in its
// registers. A warpgroup's rows reach each of its queries in ascending id
// order within a split (both warpgroups take every tile in order), so a
// row tying the root ranks after it and strict admission is exact. A drain
// runs when an append pushed some buffer past Tune::DRAIN_AT (the
// appending thread votes, one barrier a tile); a full heap publishes its
// root to the splits' shared k-th best (kshare), which every split's key
// then respects.
template <class F, class Tune, class Probe>
struct Scan {
  static_assert(Tune::DRAIN_AT <= BUF_CAP - F::TILE_N, "a tile must fit");
  Probe probe;
  unsigned char* smem;  // 1024-byte aligned
  uint64_t *full, *empty, *qbar;
  float* key_s;
  int* cnt_s;
  float* vec_s;
  unsigned char *qres, *ring;  // resident queries (kch chunks), the ring
  int kch, stage_bytes;        // rows (and queries, when not resident)
  bool res;
  int B, N, k, slab_len, buf_at;
  int tid, wg, tw, q0, t_begin, t_end, total;
  int2* slab0;
  int qo;  // the query an owner owns
  bool owner, own_live;
  int2* heap;
  unsigned* shared_key;  // owners only
  int warp, lane, g, tig, bar_id, qb[2];
  float key[2];  // the keys of queries qb, renewed by each drain
  bool crossed;  // an append of mine pushed a buffer past DRAIN_AT

  __device__ __forceinline__ Scan(unsigned char* smem_raw, int B_, int N_,
                                  int row_bytes, int k_, int ntiles,
                                  int tiles_per_split, int slab_len_,
                                  int2* slabs, unsigned* kshare)
      : B(B_), N(N_), k(k_), slab_len(slab_len_) {
    probe.start();
    const uint32_t raw = smem_u32(smem_raw);
    smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
    full = reinterpret_cast<uint64_t*>(smem);
    empty = full + F::STAGES;
    qbar = empty + F::STAGES;
    key_s = reinterpret_cast<float*>(smem + F::KEY_AT);
    cnt_s = reinterpret_cast<int*>(smem + F::CNT_AT);
    vec_s = reinterpret_cast<float*>(smem + F::VEC_AT);
    kch = F::chunks(row_bytes);
    res = F::resident(row_bytes);
    qres = smem + F::HDR;
    ring = qres + (res ? kch * F::QCHUNK : 0);
    stage_bytes = res ? F::CHUNK : F::CHUNK + F::QCHUNK;
    tid = threadIdx.x;
    wg = tid / F::WG;  // 0 .. CWG - 1: consumers; CWG: the producer
    tw = tid % F::WG;
    q0 = blockIdx.x * F::TILE_Q;
    const int split = blockIdx.y;
    t_begin = split * tiles_per_split;
    t_end = min(ntiles, t_begin + tiles_per_split);
    total = max(0, t_end - t_begin) * kch;
    slab0 = slabs + ((size_t)split * B + q0) * slab_len;
    buf_at = heap_len(k);
    qo = wg * 64 + tw;
    owner = wg < F::CWG && tw < 64;
    own_live = owner && q0 + qo < B;
    heap = slab0 + (size_t)qo * slab_len + HEAP_AT;
    shared_key = kshare + q0 + qo;
    warp = tw / 32;
    lane = tid % 32;
    g = lane / 4;
    tig = lane % 4;
    bar_id = 1 + wg;
#pragma unroll
    for (int h = 0; h < 2; ++h) qb[h] = wg * 64 + warp * 16 + g + 8 * h;
    crossed = false;
    if (tid == 0) {
      for (int s = 0; s < F::STAGES; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, F::CWG);  // one arrival per consumer warpgroup
      }
      mbar_init(qbar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (owner) {
      if (own_live) {
        for (int i = 0; i < k; ++i) heap[i] = empty_entry();
      }
      key_s[qo] = own_live ? -CUDART_INF_F : CUDART_INF_F;
      cnt_s[qo] = 0;
    }
    __syncthreads();
  }

  // Vector v of ring stage s (a tile's rows).
  __device__ __forceinline__ float* vec(int s, int v) const {
    return vec_s + (s * F::VECS + v) * F::TILE_N;
  }

  // The producer warpgroup (the kernel's `if` on wg == CWG; the consumers
  // take its `else`: the two roles never reconverge, so the register
  // counts each sets hold). It gives its registers to the consumers, and
  // lane 0 of its first warp issues every copy of the split: the block's
  // queries once (when resident), then per unit (tile, chunk) the chunk of
  // rows (and of the queries) and, on a tile's first chunk, its vectors
  // (zeros past N), each landing on its stage's barrier.
  __device__ __forceinline__ void produce(
      const CUtensorMap* qmap, const CUtensorMap* xmap,
      const CUtensorMap* const (&vmaps)[F::VECS]) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     F::PRODUCER_REGS)
                 : "memory");
    if (tw != 0) return;
    if (res && total > 0) {
      mbar_arrive_tx(qbar, kch * F::QCHUNK);
      for (int c = 0; c < kch; ++c) {
        tma_load(qres + c * F::QCHUNK, qmap, c * F::KB, q0, qbar);
      }
    }
    probe.mark(P_ISSUE);
    for (int u = 0; u < total; ++u) {
      const int s = u % F::STAGES;
      if (u >= F::STAGES) mbar_wait(empty + s, (u / F::STAGES - 1) & 1);
      probe.mark(P_EMPTY_WAIT);
      const int t = t_begin + u / kch;
      const int c = u % kch;
      unsigned char* const st = ring + s * stage_bytes;
      mbar_arrive_tx(full + s, stage_bytes +
                                   (c == 0 ? F::VECS * F::TILE_N * 4 : 0));
      tma_load(st, xmap, c * F::KB, t * F::TILE_N, full + s);
      if (!res) tma_load(st + F::CHUNK, qmap, c * F::KB, q0, full + s);
      if (c == 0) {
#pragma unroll
        for (int v = 0; v < F::VECS; ++v) {
          tma_load_1d(vec(s, v), vmaps[v], t * F::TILE_N, full + s);
        }
      }
      probe.mark(P_ISSUE);
    }
    probe.finish();
  }

  // A consumer thread's start: it takes the producer's registers and its
  // queries' keys.
  __device__ __forceinline__ void consumer() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     F::CONSUMER_REGS)
                 : "memory");
    key[0] = key_s[qb[0]];
    key[1] = key_s[qb[1]];
  }

  // The resident queries have landed.
  __device__ __forceinline__ void wait_queries() {
    if (res && total > 0) mbar_wait(qbar, 0);
    probe.mark(P_SETUP);
  }

  // Chunk c of a tile, in ring stage s, into acc: every k-step through
  // mma(acc, a, b, scale_d) (bytes past the row arrive as zeros),
  // committed as one group.
  template <class Acc, class Mma>
  __device__ __forceinline__ void issue(Acc& acc, int s, int c, Mma mma) {
    unsigned char* const st = ring + s * stage_bytes;
    const uint32_t a0 =
        smem_u32(res ? qres + c * F::QCHUNK : st + F::CHUNK) + wg * 64 * F::KB;
    const uint32_t b0 = smem_u32(st);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < F::KB / F::KSTEP; ++ks) {
      mma(acc, desc_sw128(a0 + ks * F::KSTEP), desc_sw128(b0 + ks * F::KSTEP),
          c > 0 || ks > 0);
    }
    wgmma_commit();
  }

  // If an append pushed a buffer past DRAIN_AT (or, every REFRESH tiles,
  // an owner sees a better shared k-th best), every owner drains its
  // buffer into its heap, a full heap publishes its root, and the keys are
  // renewed; then renew() (the form's terms of the new keys). One barrier
  // a tile; it also orders the row terms written before it.
  template <class Renew>
  __device__ __forceinline__ void drain_check(int t, Renew renew) {
    bool better = false;
    if (own_live && (t - t_begin) % Tune::REFRESH == Tune::REFRESH - 1) {
      better = admission_key(-CUDART_INF_F, key_dec(__ldcg(shared_key))) >
               key_s[qo];
    }
    if (wg_any(bar_id, crossed || better)) {
      if (own_live) {
        const int n = cnt_s[qo];
        const float root =
            __int_as_float(n > 0 ? drain(heap, k, n).x : heap[0].x);
        // a full heap publishes its root, and every owner takes the best
        // root published
        const unsigned ext =
            root > -CUDART_INF_F
                ? max(atomicMax(shared_key, key_enc(root)), key_enc(root))
                : __ldcg(shared_key);
        key_s[qo] = admission_key(root, key_dec(ext));
        cnt_s[qo] = 0;
      }
      wg_sync(bar_id);
      key[0] = key_s[qb[0]];
      key[1] = key_s[qb[1]];
      crossed = false;
      renew();
    }
    probe.mark(P_DRAIN);
  }

  // Append (score, row) to query qb[h]'s buffer.
  __device__ __forceinline__ void append(int h, float score, int row) {
    probe.count(C_ADMITTED, 1);
    const int slot = atomicAdd(&cnt_s[qb[h]], 1);
    crossed |= slot + 1 > Tune::DRAIN_AT;
    slab0[(size_t)qb[h] * slab_len + buf_at + slot] =
        make_int2(__float_as_int(score), row);
  }

  // The split's tiles with one accumulator set: a warpgroup scores tile t
  // (epi(acc, t)) after its MMAs, while the other warpgroup's MMAs run;
  // its row terms (rows(s, t), from ring stage s of the tile's first
  // chunk) and its drain vote (renew() after a drain) run under its own.
  // The stage is released by lane 0 once the chunk's MMAs are done, so a
  // barrier of the warpgroup comes between every warp's reads of it and
  // the release: the drain vote's on a tile of one chunk, else its own.
  template <class Acc, class Rows, class Mma, class Epi, class Renew>
  __device__ __forceinline__ void tiles(Acc& acc, Rows rows, Mma mma,
                                        Epi epi, Renew renew) {
    wait_queries();
    int u = 0;  // units (tile, chunk) taken so far
    for (int t = t_begin; t < t_end; ++t) {
      for (int c = 0; c < kch; ++c) {
        const int s = u % F::STAGES;
        mbar_wait(full + s, (u / F::STAGES) & 1);
        probe.mark(P_FULL_WAIT);
        issue(acc, s, c, mma);
        if (c == 0) {
          rows(s, t);
          probe.mark(P_ROWS);
        }
        if (c + 1 == kch && Tune::SCORES) {
          drain_check(t, renew);
        } else if (c == 0) {
          wg_sync(bar_id);  // the rows read before the stage's release
        }
        wgmma_wait<0>();
        if (tw == 0) mbar_arrive(empty + s);
        ++u;
      }
      acc_fence(acc);
      probe.mark(P_MMA);
      if (Tune::SCORES) epi(acc, t);
    }
  }

  // The last tile's appends drained, and each heap sorted in place into
  // its list g[0..k), best first.
  __device__ __forceinline__ void finish() {
    wg_sync(bar_id);  // the last tile's appends are in
    if (own_live) {
      drain(heap, k, cnt_s[qo]);
      for (int m = k - 1; m >= 1; --m) {
        const int2 last = heap[m];
        heap[m] = heap[0];
        heap[0] = sift_down(heap, m, 0, last);
      }
    }
    probe.mark(P_LAST);
    probe.finish();
  }
};

// A launch of a wgmma form: its grid, and the checks, set-up and merge
// around its kernel.
template <class F>
struct Launch {
  int ntiles, tiles_per_split, slab_len, smem;
  dim3 grid;

  Launch(int B, int N, int row_bytes, int k, int splits)
      : ntiles((N + F::TILE_N - 1) / F::TILE_N),
        tiles_per_split(splits > 0 ? (ntiles + splits - 1) / splits : 0),
        slab_len(heap_len(k) + BUF_CAP),
        smem(F::smem_bytes(row_bytes)),
        grid((B + F::TILE_Q - 1) / F::TILE_Q, splits > 0 ? splits : 1) {}

  // Whether the launch takes N rows in `splits` splits, none empty.
  bool takes(int N, int splits) const {
    return N >= 0 && splits >= 1 && splits <= (ntiles > 1 ? ntiles : 1) &&
           splits <= 65535;
  }

  // The kernel's shared memory set, the shared k-th best zeroed.
  template <class Kernel>
  int prepare(Kernel* kernel, int B, unsigned* kshare,
              cudaStream_t stream) const {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      err = cudaMemsetAsync(kshare, 0, (size_t)B * sizeof(unsigned), stream);
    }
    return (int)err;
  }

  // After the kernel's launch: its error, else the splits' merge.
  int finish(int2* slabs, int B, int k, int splits, float* out_s, int* out_i,
             cudaStream_t stream) const {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return rht_scan::launch_merge(slabs, slab_len, B, k, splits, out_s, out_i,
                                  stream);
  }
};

// Blocks of `kernel` (geometry F) an SM holds at rows of row_bytes, or -1.
template <class F, class Kernel>
int resident_blocks(Kernel* kernel, int row_bytes) {
  const int smem = F::smem_bytes(row_bytes);
  int n = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, F::THREADS,
                                                    smem) != cudaSuccess) {
    return -1;
  }
  return n;
}

}  // namespace rht_hopper
