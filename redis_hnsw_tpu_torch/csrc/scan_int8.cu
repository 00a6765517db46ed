// Kernel A-int8, the Hopper form: the int8 scan tier's select on warpgroup
// MMA, with TMA-fed row tiles, the query tile resident in shared memory
// and the score epilogue beside the tensor cores.
//
// The JAX package scores this tier in XLA (redis_hnsw_tpu/ops/scan.py
// _chunk_scores, :157-171: an int8 jnp.dot, then lax.top_k per chunk); no
// Pallas kernel of its stands behind it. Per query, the top k rows of the
// table by
//
//   dot   = the int8 x int8 -> int32 product of the per-row quantized
//           query and row (exact),
//   score = __fsub_rn(__fsub_rn(__fmul_rn(2, __fmul_rn(__int2float_rn(dot),
//             __fmul_rn(qscale, tscale))), qq), sq)
//
// best first, ties to the lowest row id, (-inf, -1) in empty slots: the
// function of scan_lowp.cu's lowp_tile_kernel<Int8Core> (the general form,
// which serves rows that are not a multiple of 16 bytes and operands off a
// 16-byte boundary), bit for bit on any data.
//
// Bound on the H100: 2*B*N*D int8 tensor-core operations (0.265 ms at B =
// 2048, N = 1,000,064, D = 128) against (B + N)*D bytes. The general form
// runs at 9% of it (2.83 ms): its epilogue (nine instructions a score)
// costs more than its mma.sync products and runs after them, and it copies
// its queries again for every row tile. Here:
//
// * A block holds 128 queries: two consumer warpgroups of 64, each with
//   its own queries against the same row tile, and a producer warpgroup
//   whose first lane keeps a ring of STAGES chunks in flight: 2-D tensor
//   copies (TMA) of 128 rows x 128 bytes of the [N, row_bytes] table in
//   the 128-byte swizzle, and 1-D ones of the tile's tscale and sq, each
//   landing on its stage's mbarrier; rows past N and bytes past the row
//   arrive as zeros. The block's queries arrive once, the same way, and
//   stay resident for the whole split up to QRES_CHUNKS chunks (rows of up
//   to 1024 bytes); wider rows stream their query chunk through the ring
//   beside the row chunk. The producer gives its registers to the
//   consumers (setmaxnreg).
// * Each consumer warpgroup issues wgmma.mma_async m64n128k32 .s32.s8.s8,
//   both operands K-major from shared memory. Thread (warp w, lane 4g + i)
//   holds queries 16w + g and 16w + g + 8 of its warpgroup against 32 rows
//   each, so the queries' key, qq and scale live in registers. A
//   warpgroup scores tile t while the other's MMAs run, and computes tile
//   t's row terms and its drain vote under its own (SETS = 1). Two
//   accumulator sets (SETS = 2: tile t - 1 scored under tile t's MMAs)
//   need more than the 168 registers a thread of a 384-thread block gets
//   and spill; tools/lowp_core_study.cu times both.
// * The epilogue's common case is one add-max a score (see the filter
//   below): top = max(dot - beta(row)) per query, against alpha(query).
//   Rows past it are scored exactly, one a lane at a time, and admitted
//   strictly above the query's key.
// * Selection: kernel A's heaps, drain and list_merge_kernel
//   (scan_heap.cuh). A warpgroup's rows reach each of its queries in
//   ascending id order within a split (both warpgroups take every tile in
//   order), so a row tying the root ranks after it and strict admission
//   is exact. Threads 0..63 of a warpgroup own its queries' heaps; a
//   drain runs when an append pushed some buffer past DRAIN_AT (the
//   appending thread votes, one barrier a tile). A full heap publishes its
//   root to the splits' shared k-th best (kshare), which every split's key
//   then respects.
//
// tools/lowp_core_study.cu times this form beside the general form, with
// the exact score of every row (FILTER = false) beside the filter, and
// where a block's cycles go; PERF.md has the numbers.
//
// C interface (ctypes, ops/cuda_scan.py): scan_int8_launch (returns a CUDA
// error code, cudaErrorInvalidValue for a shape or alignment the form
// cannot take, or cudaErrorNotSupported if a tensor map cannot be made),
// scan_int8_slots, scan_int8_smem_bytes and scan_int8_query_tile.

#include <cuda.h>

#include "scan_heap.cuh"

namespace rht_int8 {

using rht_scan::BUF_CAP;
using rht_scan::HEAP_AT;
using rht_scan::drain;
using rht_scan::empty_entry;
using rht_scan::heap_len;
using rht_scan::sift_down;

// consumer warpgroups a block, each with its own 64 queries (the study
// builds others with -DRHT_INT8_CWG=n)
#ifndef RHT_INT8_CWG
#define RHT_INT8_CWG 2
#endif
constexpr int CWG = RHT_INT8_CWG;
constexpr int TILE_Q = 64 * CWG;  // queries a block
constexpr int TILE_N = 128;      // rows a tile: the wgmma's n
constexpr int KB = 128;          // bytes of a row a chunk: the swizzle span
constexpr int KSTEP = 32;        // bytes of a row a wgmma k-step
constexpr int STAGES = 4;
constexpr int CHUNK = TILE_N * KB;   // 16 KB: a chunk of rows
constexpr int QCHUNK = TILE_Q * KB;  // a chunk of the block's queries
constexpr int QRES_CHUNKS = 8;      // resident queries: rows <= 1024 bytes
constexpr int WG = 128;             // threads a warpgroup
constexpr int THREADS = (CWG + 1) * WG;  // consumers + the producer
// registers a thread: the producer gives its own to the consumers
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS =
    (65536 / WG - PRODUCER_REGS) / CWG / 8 * 8 > 232
        ? 232
        : (65536 / WG - PRODUCER_REGS) / CWG / 8 * 8;
constexpr int ACC = TILE_N / 2;     // accumulators a thread
// |dot| <= 127^2 * row_bytes < 2^29: the filter's sums stay in int32
constexpr int MAX_ROW_BYTES = 32768;
// The selection's knobs (tools/lowp_core_study.cu times other values): a
// drain runs once an append pushed a buffer past DRAIN_AT entries (at most
// BUF_CAP - TILE_N: a tile must fit); every REFRESH tiles an owner looks
// for a better shared k-th best. SCORES = false leaves the MMAs and copies
// alone, a timing the study takes.
struct Tuning {
  static constexpr int DRAIN_AT = 16;
  static constexpr int REFRESH = 64;
  static constexpr bool SCORES = true;
};
// shared memory: barriers; key and count per query; each stage's tscale
// and sq; three buffers of row terms (beta) and of the rows' tscale and sq
// per consumer warpgroup (a tile's stage is refilled before its epilogue);
// the warpgroups' reduction partials; the operands from HDR
constexpr int KEY_AT = 128;
constexpr int CNT_AT = KEY_AT + TILE_Q * 4;
constexpr int TSQ_AT = CNT_AT + TILE_Q * 4;
constexpr int BETA_AT = TSQ_AT + STAGES * 2 * TILE_N * 4;
constexpr int TSC_AT = BETA_AT + CWG * 3 * TILE_N * 4;  // tscale, sq copies
constexpr int RED_AT = TSC_AT + CWG * 3 * 2 * TILE_N * 4;
constexpr int HDR = (RED_AT + CWG * 4 * 8 * 4 + 1023) / 1024 * 1024;
constexpr unsigned FULL = 0xffffffffu;

// The kernel's parts are lambdas over its state; each is inlined, so the
// accumulators stay in registers.
#define RHT_INLINE __attribute__((always_inline))

static_assert(BUF_CAP == 2 * TILE_N, "a buffer takes two tiles");
static_assert(Tuning::DRAIN_AT <= BUF_CAP - TILE_N, "a tile must fit");

__host__ __device__ constexpr int chunks(int row_bytes) {
  return (row_bytes + KB - 1) / KB;
}

__host__ __device__ constexpr bool resident(int row_bytes) {
  return chunks(row_bytes) <= QRES_CHUNKS;
}

// Dynamic shared memory of a block (1024 bytes of it for alignment).
__host__ __device__ constexpr int smem_bytes(int row_bytes) {
  return 1024 + HDR +
         (resident(row_bytes) ? chunks(row_bytes) * QCHUNK + STAGES * CHUNK
                              : STAGES * (CHUNK + QCHUNK));
}

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

// d (+)= A[64 x 32] . B[128 x 32]^T, s8 x s8 -> s32; d is overwritten
// when scale_d is 0.
__device__ __forceinline__ void wgmma_s8(int (&d)[ACC], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
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

// After a wait: the accumulators are read only from here on.
__device__ __forceinline__ void acc_fence(int (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+r"(d[i])::"memory");
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

// -- the score and the filter ----------------------------------------------

__device__ __forceinline__ float score(int dot, float qn, float qsc, float sn,
                                       float tsc) {
  const float dq = __fmul_rn(__int2float_rn(dot), __fmul_rn(qsc, tsc));
  return __fsub_rn(__fsub_rn(__fmul_rn(2.f, dq), qn), sn);
}

// The filter. With mu = 1 / (2 qscale), C = (key + qq) mu per query (key:
// its admission key), and v = 1 / tscale, w = sq / tscale per row, a row
// can score above the key only if (real arithmetic)
//
//   dot > theta = C v + mu w
//             = [C vbar + mu wbar] + [C (v - vbar) + mu (w - wbar)]
//            >= alpha(query)       + beta(row)
//
// where beta takes the least of C (v - vbar) over C in [c_lo, c_hi] (the
// warpgroup's live queries' C when it was computed) and of mu (w - wbar)
// over mu in [mu_lo, mu_hi]; vbar, wbar are the block's reference row
// values (the midranges of its split's first tile). Both sides are
// floored with a relative margin of 2^-16 of every magnitude in them (the
// score's four roundings and the float evaluation of alpha and beta are
// within 2^-20 of those), so dot <= alpha + beta means the computed score
// at dot = alpha + beta, hence at every smaller dot (each rounded step is
// monotone in it), is at most the key. A query whose C lies outside the
// range beta used (a key that rose since: C clamped to c_hi, which only
// lowers theta; one below c_lo: every row passes), a dead row (never
// passes), and any value outside the terms of the argument (scales <= 0
// or not finite, sq < 0, NaN; every row passes to the exact test) keep it
// conservative. The row terms are stored negated, so the add-max is
// __viaddmax_s32(dot, -beta, top).
//
// The filter's integers: a normal term lies in [-LIM, LIM] (floored, and
// clamped only downward), |dot| < LIM (rows <= MAX_ROW_BYTES), so every
// sum acc - beta stays in int32. Sentinels: a row that never scores
// (beta = 2 LIM: acc - beta < -LIM), a row that always passes (beta = -2
// LIM: acc - beta > LIM); a query that passes every row (alpha = INT_MIN),
// one past B (alpha = INT_MAX).
constexpr int LIM = 1 << 29;
constexpr float REL = 0x1p-16f;

__device__ __forceinline__ int floor_term(float x, int below) {
  if (!(x >= -(float)LIM)) return below;  // also NaN
  if (x > (float)LIM) return LIM;
  return __float2int_rd(x);
}

struct Ranges {
  float c_lo, c_hi;  // the warpgroup's live queries' C
  float k1;          // their largest |C| + |qq| mu
};

// beta of a row with tscale ts and sq (either may be garbage).
__device__ __forceinline__ int row_beta(float ts, float sq, bool live_row,
                                        const Ranges& rg, float mu_lo,
                                        float mu_hi, float vbar, float wbar) {
  if (!live_row || !(sq < CUDART_INF_F) || ts != ts) return 2 * LIM;
  if (!(ts > 0.f) || !(ts < CUDART_INF_F) || !(sq >= 0.f) ||
      !(rg.c_lo <= rg.c_hi) || !(mu_lo <= mu_hi)) {
    return -2 * LIM;  // the exact test decides
  }
  const float v = __fdividef(1.f, ts);  // (its error is in the margin)
  const float w = sq * v;
  const float dv = v - vbar, dw = w - wbar;
  const float t1 = fminf(rg.c_lo * dv, rg.c_hi * dv);
  const float t2 = fminf(mu_lo * dw, mu_hi * dw);
  const float mag = fabsf(t1) + fabsf(t2) +
                    (fabsf(rg.c_lo) + fabsf(rg.c_hi)) * fabsf(dv) +
                    mu_hi * fabsf(dw) + v * rg.k1 + mu_hi * w +
                    fabsf(rg.c_hi * vbar) + mu_hi * fabsf(wbar);
  return floor_term(t1 + t2 - mag * REL - 4.f, -2 * LIM);
}

// alpha of a query (C, mu) against a tile whose beta used ranges rg.
__device__ __forceinline__ int query_alpha(float c, float mu, bool finite,
                                           const Ranges& rg, float vbar,
                                           float wbar) {
  if (c == CUDART_INF_F) return INT_MAX;  // a query past B
  if (!finite || !(c >= rg.c_lo)) return INT_MIN;
  const float cc = fminf(c, rg.c_hi);
  const float a = cc * vbar + mu * wbar;
  const float mag = fabsf(cc * vbar) + fabsf(mu * wbar);
  return floor_term(a - mag * REL - 4.f, INT_MIN);
}

// The splits' shared k-th best: per query, the largest heap root (the
// k-th best score of a split's rows so far, once its heap is full) any
// split has published, as an order-keeping unsigned (0: none). The final
// k-th best is at least that, so a split may drop any row scoring below
// it: no such row is among the final k (rows tying it are kept, for the
// lowest-id rule).
__device__ __forceinline__ unsigned key_enc(float f) {
  const unsigned u = __float_as_uint(f);
  return u & 0x80000000u ? ~u : u | 0x80000000u;
}

__device__ __forceinline__ float key_dec(unsigned e) {
  if (e == 0u) return -CUDART_INF_F;
  return __uint_as_float(e & 0x80000000u ? e & 0x7fffffffu : ~e);
}

// The admission key of a split whose heap root scores `root`, given the
// shared k-th best `ext`: admit a row iff it scores above the root and at
// least ext, i.e. above the larger of root and the float below ext.
__device__ __forceinline__ float admission_key(float root, float ext) {
  return ext > -CUDART_INF_F ? fmaxf(root, nextafterf(ext, -CUDART_INF_F))
                             : root;
}

// -- cycle counters for tools/lowp_core_study.cu ----------------------------

// Phases of a consumer warp, and of the producer warp.
enum {
  P_SETUP,
  P_FULL_WAIT,   // waiting for a chunk's copy
  P_BETA,        // the tile's row terms (beta)
  P_MMA,         // issuing wgmma, waiting for the previous tile's
  P_DRAIN,       // the drain vote and drains (and the query ranges)
  P_COMPARE,     // alpha, one add-max a score, the warp's vote
  P_ADMIT,       // exact scores of the rows past the filter, appends
  P_LAST,        // the last drain and the heap sort
  P_EMPTY_WAIT,  // producer: waiting for a free stage
  P_ISSUE,       // producer: issuing copies
  PHASES
};

// Counts of the study's probe: warp epilogues, those that took the exact
// path, values past the filter, rows admitted.
enum { C_EPILOGUES, C_SLOW, C_PASSED, C_ADMITTED, COUNTS };

struct NoProbe {
  static constexpr bool COUNTING = false;
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void count(int, int) {}
  __device__ void finish() {}
};

// -- the kernel -------------------------------------------------------------

// Block (query tile, split) selects, per query, the top k of its split's
// rows into the (split, query) slab. FILTER: the epilogue's filter
// (shipped); false: every score exact. SETS: accumulator sets a consumer
// warpgroup (2: it scores tile t - 1 while tile t's MMAs run; 1: the other
// warpgroup's MMAs run meanwhile). The study times each.
template <bool FILTER, int SETS, class Probe, class Tune = Tuning>
__global__ void __launch_bounds__(THREADS, 1)
    int8_tile_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap tsmap,
                     const __grid_constant__ CUtensorMap sqmap,
                     const float* __restrict__ qq,
                     const float* __restrict__ qscale, int B, int N,
                     int row_bytes, int k, int ntiles, int tiles_per_split,
                     int slab_len, int2* __restrict__ slabs,
                     unsigned* __restrict__ kshare) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* const smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* const empty = full + STAGES;
  uint64_t* const qbar = empty + STAGES;
  float* const key_s = reinterpret_cast<float*>(smem + KEY_AT);
  int* const cnt_s = reinterpret_cast<int*>(smem + CNT_AT);
  float* const tsq_s = reinterpret_cast<float*>(smem + TSQ_AT);
  int* const nbeta_s = reinterpret_cast<int*>(smem + BETA_AT);
  float* const tsc_s = reinterpret_cast<float*>(smem + TSC_AT);
  float* const red_s = reinterpret_cast<float*>(smem + RED_AT);
  unsigned char* const ops = smem + HDR;
  const int kch = chunks(row_bytes);
  const bool res = resident(row_bytes);
  unsigned char* const qres = ops;  // resident queries, kch chunks
  unsigned char* const ring = ops + (res ? kch * QCHUNK : 0);
  const int stage_bytes = res ? CHUNK : CHUNK + QCHUNK;  // rows (, queries)

  Probe probe;
  probe.start();
  const int tid = threadIdx.x;
  const int wg = tid / WG;  // 0, 1: consumers; 2: the producer
  const int tw = tid % WG;
  const int q0 = blockIdx.x * TILE_Q;
  const int split = blockIdx.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  const int total = max(0, t_end - t_begin) * kch;
  int2* const slab0 = slabs + ((size_t)split * B + q0) * slab_len;
  const int buf_at = heap_len(k);

  // the owner of query qo: thread tw < 64 of warpgroup wg
  const int qo = wg * 64 + tw;
  const bool owner = wg < CWG && tw < 64;
  const bool own_live = owner && q0 + qo < B;
  int2* const heap = slab0 + (size_t)qo * slab_len + HEAP_AT;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CWG);  // one arrival per consumer warpgroup
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

  if (wg == CWG) {
    // the producer: lane 0 of its first warp issues every copy of the
    // split; the warpgroup gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (tw != 0) return;
    if (res && total > 0) {
      mbar_arrive_tx(qbar, kch * QCHUNK);
      for (int c = 0; c < kch; ++c) {
        tma_load(qres + c * QCHUNK, &qmap, c * KB, q0, qbar);
      }
    }
    probe.mark(P_ISSUE);
    for (int u = 0; u < total; ++u) {
      const int s = u % STAGES;
      if (u >= STAGES) mbar_wait(empty + s, (u / STAGES - 1) & 1);
      probe.mark(P_EMPTY_WAIT);
      const int t = t_begin + u / kch;
      const int c = u % kch;
      unsigned char* const st = ring + s * stage_bytes;
      mbar_arrive_tx(full + s, stage_bytes + (c == 0 ? 2 * TILE_N * 4 : 0));
      tma_load(st, &xmap, c * KB, t * TILE_N, full + s);
      if (!res) tma_load(st + CHUNK, &qmap, c * KB, q0, full + s);
      if (c == 0) {  // the tile's tscale and sq (zeros past N)
        float* const slot = tsq_s + s * 2 * TILE_N;
        tma_load_1d(slot, &tsmap, t * TILE_N, full + s);
        tma_load_1d(slot + TILE_N, &sqmap, t * TILE_N, full + s);
      }
      probe.mark(P_ISSUE);
    }
    probe.finish();
  } else {
    // the consumers (one if-else: the two roles never reconverge, so the
    // register counts set here hold)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
                 : "memory");

    // a consumer: warp w of warpgroup wg, lane 4g + tig, holds queries qb[h]
    // = 64 wg + 16 w + g + 8h against rows 8j + 2 tig + e of each tile
    const int warp = tw / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int tig = lane % 4;
    const int bar_id = 1 + wg;
    int qb[2];
    float qn[2], qsc[2], mu[2], key[2], cq[2];
    bool fin[2];  // mu and C finite: the filter's terms hold
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qb[h] = wg * 64 + warp * 16 + g + 8 * h;
      const bool live = q0 + qb[h] < B;
      qn[h] = live ? qq[q0 + qb[h]] : 0.f;
      qsc[h] = live ? qscale[q0 + qb[h]] : 1.f;
      mu[h] = __frcp_rn(2.f * qsc[h]);
      key[h] = key_s[qb[h]];
    }
    float* const red = red_s + wg * 4 * 8;  // [warp][8] partials
    // Reduce (lo, hi, top) over the warpgroup: the least of a, the largest
    // of b and of c. Every thread of the warpgroup calls it.
    auto wg_reduce = [&](float a, float b, float c, int at, float& lo,
                         float& hi, float& top) RHT_INLINE {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a = fminf(a, __shfl_xor_sync(FULL, a, o));
        b = fmaxf(b, __shfl_xor_sync(FULL, b, o));
        c = fmaxf(c, __shfl_xor_sync(FULL, c, o));
      }
      if (lane == 0) {
        red[warp * 8 + at] = a;
        red[warp * 8 + at + 1] = b;
        red[warp * 8 + at + 2] = c;
      }
      wg_sync(bar_id);
      lo = fminf(fminf(red[at], red[8 + at]),
                 fminf(red[16 + at], red[24 + at]));
      hi = fmaxf(fmaxf(red[at + 1], red[8 + at + 1]),
                 fmaxf(red[16 + at + 1], red[24 + at + 1]));
      top = fmaxf(fmaxf(red[at + 2], red[8 + at + 2]),
                  fmaxf(red[16 + at + 2], red[24 + at + 2]));
    };
    // C of each of my queries from its key, and the warpgroup's ranges
    Ranges rg;
    auto queries_changed = [&]() RHT_INLINE {
      float a = CUDART_INF_F, b = -CUDART_INF_F, c = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cq[h] = __fmul_rn(key[h] + qn[h], mu[h]);
        fin[h] = fabsf(cq[h]) < CUDART_INF_F && mu[h] > 0.f &&
                 mu[h] < CUDART_INF_F && fabsf(qn[h]) < CUDART_INF_F;
        if (key[h] == CUDART_INF_F) cq[h] = CUDART_INF_F;  // past B
        if (fin[h]) {
          a = fminf(a, cq[h]);
          b = fmaxf(b, cq[h]);
          c = fmaxf(c, fabsf(cq[h]) + fabsf(qn[h]) * mu[h]);
        }
      }
      wg_reduce(a, b, c, 0, rg.c_lo, rg.c_hi, rg.k1);
    };
    float mu_lo, mu_hi, vbar = 0.f, wbar = 0.f;
    {
      float a = CUDART_INF_F, b = -CUDART_INF_F, unused;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (q0 + qb[h] < B && mu[h] > 0.f && mu[h] < CUDART_INF_F) {
          a = fminf(a, mu[h]);
          b = fmaxf(b, mu[h]);
        }
      }
      wg_reduce(a, b, 0.f, 3, mu_lo, mu_hi, unused);
    }
    queries_changed();
    bool crossed = false;  // an append of mine pushed a buffer past DRAIN_AT

    // If an append pushed a buffer past DRAIN_AT, every owner drains its
    // buffer into its heap, and the keys and ranges are renewed. One
    // barrier a tile; it also orders the row terms written before it.
    bool drained = false;
    unsigned* const shared_key = kshare + q0 + qo;  // owners only
    auto drain_check = [&](int t) RHT_INLINE {
      // every 16 tiles an owner looks for a better shared k-th best
      bool better = false;
      if (own_live && (t - t_begin) % Tune::REFRESH == Tune::REFRESH - 1) {
        better = admission_key(-CUDART_INF_F, key_dec(__ldcg(shared_key))) >
                 key_s[qo];
      }
      if (wg_any(bar_id, crossed || better)) {
        if (own_live) {
          const int n = cnt_s[qo];
          const float root = __int_as_float(n > 0 ? drain(heap, k, n).x
                                                  : heap[0].x);
          // a full heap publishes its root, and every owner takes the
          // best root published
          const unsigned ext =
              root > -CUDART_INF_F ? max(atomicMax(shared_key, key_enc(root)),
                                         key_enc(root))
                                   : __ldcg(shared_key);
          key_s[qo] = admission_key(root, key_dec(ext));
          cnt_s[qo] = 0;
        }
        wg_sync(bar_id);
        key[0] = key_s[qb[0]];
        key[1] = key_s[qb[1]];
        crossed = false;
        queries_changed();
        drained = true;
      }
      probe.mark(P_DRAIN);
    };
    int alpha[2];              // the queries' filter terms, as last computed
    float a_lo = CUDART_NAN_F;  // ... under these ranges (none yet)
    float a_hi = CUDART_NAN_F;
    // Score finished tile t (accumulators acc, row terms of buffer bi made
    // under ranges brg) and append every row that beats its query's key.
    auto epilogue = [&](const int (&acc)[ACC], int t, int bi,
                        const Ranges& brg) RHT_INLINE {
      if (drained || !(brg.c_lo == a_lo && brg.c_hi == a_hi)) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          alpha[h] = FILTER
                         ? query_alpha(cq[h], mu[h], fin[h], brg, vbar, wbar)
                         : (key[h] == CUDART_INF_F ? INT_MAX : INT_MIN);
        }
        a_lo = brg.c_lo;
        a_hi = brg.c_hi;
        drained = false;
      }
      const int r0 = t * TILE_N;
      const int* const nbeta = nbeta_s + (wg * 3 + bi) * TILE_N;
      const float* const tsc = tsc_s + (wg * 3 + bi) * 2 * TILE_N;
      // acc[4j + 2h + e]: query qb[h], row r0 + 8j + 2 tig + e; one
      // add-max a score, in four chains a query
      int top[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int x = 0; x < 4; ++x) top[h][x] = INT_MIN;
#pragma unroll
      for (int j = 0; j < ACC / 4; ++j) {
        const int2 nb =
            *reinterpret_cast<const int2*>(nbeta + 8 * j + 2 * tig);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int& m0 = top[h][(2 * j) % 4];
          int& m1 = top[h][(2 * j + 1) % 4];
          m0 = __viaddmax_s32(acc[4 * j + 2 * h], nb.x, m0);
          m1 = __viaddmax_s32(acc[4 * j + 2 * h + 1], nb.y, m1);
        }
      }
      bool pass[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pass[h] = max(max(top[h][0], top[h][1]), max(top[h][2], top[h][3])) >
                  alpha[h];
      }
      const bool any = __any_sync(FULL, pass[0] || pass[1]);
      probe.mark(P_COMPARE);
      probe.count(C_EPILOGUES, lane == 0);
      if (!any) return;
      probe.count(C_SLOW, lane == 0);
      // The rows past the filter, a few a warp. Bit 2j + e of cm[h]: acc[4j
      // + 2h + e] is one. Each lane takes one of each query's at a time
      // (the accumulators are only read: a write would make the next wgmma
      // wait on it), scores both exactly and appends those that qualify.
      unsigned cm[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < ACC / 4; ++j) {
        const int2 nb =
            *reinterpret_cast<const int2*>(nbeta + 8 * j + 2 * tig);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          cm[h] |= (unsigned)(pass[h] && acc[4 * j + 2 * h] + nb.x > alpha[h])
                   << (2 * j);
          cm[h] |=
              (unsigned)(pass[h] && acc[4 * j + 2 * h + 1] + nb.y > alpha[h])
              << (2 * j + 1);
        }
      }
      while (__any_sync(FULL, (cm[0] | cm[1]) != 0)) {
        float sc[2];
        int rl[2];
        bool ok[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool has = cm[h] != 0;
          const int i = has ? __ffs(cm[h]) - 1 : 0;
          cm[h] &= cm[h] - 1;
          if (Probe::COUNTING) probe.count(C_PASSED, has);
          // acc[4 (i / 2) + 2h + i % 2], selected by i's bits
          int l0[16], l1[8], l2[4], l3[2];
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
          const int v = i & 16 ? l3[1] : l3[0];
          rl[h] = 8 * (i >> 1) + 2 * tig + (i & 1);
          sc[h] = score(v, qn[h], qsc[h], tsc[TILE_N + rl[h]], tsc[rl[h]]);
          ok[h] = has && r0 + rl[h] < N && sc[h] > key[h];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!ok[h]) continue;
          probe.count(C_ADMITTED, 1);
          const int slot = atomicAdd(&cnt_s[qb[h]], 1);
          crossed |= slot + 1 > Tune::DRAIN_AT;
          slab0[(size_t)qb[h] * slab_len + buf_at + slot] =
              make_int2(__float_as_int(sc[h]), r0 + rl[h]);
        }
      }
      probe.mark(P_ADMIT);
    };

    if (res && total > 0) mbar_wait(qbar, 0);
    probe.mark(P_SETUP);
    int u = 0;  // units (tile, chunk) issued so far
    // Tile t's row terms into buffer (t - t_begin) % 3 (and its rows'
    // tscale and sq), from ring stage s, under the current ranges; on the
    // split's first tile, the block's reference row values first.
    auto row_terms = [&](int s, int t) RHT_INLINE {
      const float* const slot = tsq_s + s * 2 * TILE_N;
      const float ts = slot[tw], sqr = slot[TILE_N + tw];
      const bool live_row = t * TILE_N + tw < N;
      if (t == t_begin) {
        const bool ok = live_row && ts > 0.f && ts < CUDART_INF_F &&
                        sqr >= 0.f && sqr < CUDART_INF_F;
        const float v = ok ? __frcp_rn(ts) : CUDART_INF_F;
        const float w = ok ? __fmul_rn(sqr, v) : CUDART_INF_F;
        float v_lo, v_hi, w_lo, w_hi, unused;
        wg_reduce(v, ok ? v : -CUDART_INF_F, 0.f, 5, v_lo, v_hi, unused);
        wg_sync(bar_id);  // the second reduction reuses the slots
        wg_reduce(w, ok ? w : -CUDART_INF_F, 0.f, 5, w_lo, w_hi, unused);
        if (v_lo <= v_hi && w_lo <= w_hi) {
          vbar = 0.5f * (v_lo + v_hi);
          wbar = 0.5f * (w_lo + w_hi);
        }
      }
      const int bi = wg * 3 + (t - t_begin) % 3;
      nbeta_s[bi * TILE_N + tw] =
          FILTER ? -row_beta(ts, sqr, live_row, rg, mu_lo, mu_hi, vbar, wbar)
                 : 0;
      tsc_s[bi * 2 * TILE_N + tw] = ts;
      tsc_s[(bi * 2 + 1) * TILE_N + tw] = sqr;
    };
    // Chunk c of a tile, in ring stage s, into acc: every k-step (bytes
    // past the row arrive as zeros), committed as one group.
    auto issue_chunk = [&](int (&acc)[ACC], int s, int c) RHT_INLINE {
      unsigned char* const st = ring + s * stage_bytes;
      const uint32_t a0 =
          smem_u32(res ? qres + c * QCHUNK : st + CHUNK) + wg * 64 * KB;
      const uint32_t b0 = smem_u32(st);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KB / KSTEP; ++ks) {
        wgmma_s8(acc, desc_sw128(a0 + ks * KSTEP),
                 desc_sw128(b0 + ks * KSTEP), c > 0 || ks > 0);
      }
      wgmma_commit();
    };
    if constexpr (SETS == 2) {
      // Issue tile t's MMAs into cur (t < t_end) and its row terms (their
      // ranges kept in cur_rg); once its first chunk is in flight, score
      // tile t - 1 from prev. t == t_end only scores.
      auto step = [&](int (&cur)[ACC], Ranges& cur_rg, int (&prev)[ACC],
                      const Ranges& prev_rg, int t) RHT_INLINE {
        const bool issue = t < t_end;
        for (int c = 0; c < kch; ++c) {
          if (issue) {
            const int s = u % STAGES;
            mbar_wait(full + s, (u / STAGES) & 1);
            probe.mark(P_FULL_WAIT);
            if (c == 0) {
              row_terms(s, t);
              cur_rg = rg;
              probe.mark(P_BETA);
            }
            issue_chunk(cur, s, c);
            wgmma_wait<1>();  // unit u - 1 is done: its stage is free
            if (u > 0 && tw == 0) mbar_arrive(empty + (u - 1) % STAGES);
            ++u;
          } else {
            wgmma_wait<0>();
          }
          acc_fence(prev);  // outside any branch: no warpgroup arrive
          probe.mark(P_MMA);
          if (c == 0 && t > t_begin) {
            drain_check(t - 1);
            epilogue(prev, t - 1, (t - 1 - t_begin) % 3, prev_rg);
          }
          if (!issue) break;
        }
      };
      int acc0[ACC], acc1[ACC];
      Ranges rg0 = rg, rg1 = rg;
      for (int t = t_begin;; t += 2) {
        step(acc0, rg0, acc1, rg1, t);
        if (t >= t_end) break;
        step(acc1, rg1, acc0, rg0, t + 1);
        if (t + 1 >= t_end) break;
      }
    } else {
      // One accumulator set: a warpgroup scores tile t after its MMAs,
      // while the other warpgroup's MMAs run; its own row terms and drain
      // vote run under its MMAs.
      int acc[ACC];
      for (int t = t_begin; t < t_end; ++t) {
        Ranges brg;
        for (int c = 0; c < kch; ++c) {
          const int s = u % STAGES;
          mbar_wait(full + s, (u / STAGES) & 1);
          probe.mark(P_FULL_WAIT);
          issue_chunk(acc, s, c);
          if (c == 0) {
            row_terms(s, t);
            brg = rg;
            probe.mark(P_BETA);
          }
          if (c + 1 == kch && Tune::SCORES) drain_check(t);
          wgmma_wait<0>();
          if (tw == 0) mbar_arrive(empty + s);
          ++u;
        }
        acc_fence(acc);
        probe.mark(P_MMA);
        if (Tune::SCORES) epilogue(acc, t, (t - t_begin) % 3, brg);
      }
    }
    wg_sync(bar_id);  // the last tile's appends are in
    if (own_live) {
      drain(heap, k, cnt_s[qo]);
      // heap-sort in place: the list g[0..k), best first
      for (int m = k - 1; m >= 1; --m) {
        const int2 last = heap[m];
        heap[m] = heap[0];
        heap[0] = sift_down(heap, m, 0, last);
      }
    }
    probe.mark(P_LAST);
    probe.finish();
  }
}

// -- host side --------------------------------------------------------------

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

// A tensor map of a [rows, row_bytes] byte table: 128 x 128-byte boxes in
// the 128-byte swizzle, zeros past the table. Made per launch (the table
// moves with each snapshot epoch, the queries with each call).
inline bool byte_map(const void* base, int rows, int row_bytes, int box_rows,
                     CUtensorMap* out) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes,
                              (cuuint64_t)(rows > 0 ? rows : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)KB, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(out, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map of an [n] float vector: 128-element boxes, zeros past it.
inline bool float_map(const float* base, int n, CUtensorMap* out) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)(n > 0 ? n : 1)};
  const cuuint64_t strides[1] = {4};  // (none for one dimension)
  const cuuint32_t box[1] = {(cuuint32_t)TILE_N};
  const cuuint32_t unit[1] = {1};
  return encode(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                const_cast<float*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether this form takes a shape: rows a multiple of 16 bytes and at
// most MAX_ROW_BYTES, the queries, the table, tscale and sq on 16-byte
// boundaries (a tensor map's terms).
inline bool takes(const void* q, const void* x, const float* sq,
                  const float* tscale, int row_bytes) {
  const auto off = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16;
  };
  return row_bytes > 0 && row_bytes % 16 == 0 &&
         row_bytes <= MAX_ROW_BYTES && off(q) == 0 && off(x) == 0 &&
         off(sq) == 0 && off(tscale) == 0;
}

template <bool FILTER, int SETS, class Probe, class Tune = Tuning>
int launch_form(const unsigned char* q, const unsigned char* x,
                const float* qq, const float* qscale, const float* sq,
                const float* tscale, int B, int N, int row_bytes, int k,
                int splits, int2* slabs, unsigned* kshare, float* out_s,
                int* out_i, cudaStream_t stream) {
  if (B <= 0 || k <= 0) return 0;
  const int ntiles = (N + TILE_N - 1) / TILE_N;
  if (N < 0 || !qscale || !tscale || !takes(q, x, sq, tscale, row_bytes) ||
      splits < 1 || splits > (ntiles > 1 ? ntiles : 1) || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap qmap, xmap, tsmap, sqmap;
  if (!byte_map(q, B, row_bytes, TILE_Q, &qmap) ||
      !byte_map(x, N, row_bytes, TILE_N, &xmap) ||
      !float_map(tscale, N, &tsmap) || !float_map(sq, N, &sqmap)) {
    return (int)cudaErrorNotSupported;
  }
  const int smem = smem_bytes(row_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      int8_tile_kernel<FILTER, SETS, Probe, Tune>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(kshare, 0, (size_t)B * sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  const int tiles_per_split = (ntiles + splits - 1) / splits;
  const int slab_len = heap_len(k) + BUF_CAP;
  const dim3 grid((B + TILE_Q - 1) / TILE_Q, splits);
  int8_tile_kernel<FILTER, SETS, Probe, Tune>
      <<<grid, THREADS, smem, stream>>>(
      qmap, xmap, tsmap, sqmap, qq, qscale, B, N, row_bytes, k, ntiles,
      tiles_per_split, slab_len, slabs, kshare);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return rht_scan::launch_merge(slabs, slab_len, B, k, splits, out_s, out_i,
                                stream);
}

template <bool FILTER, int SETS, class Probe>
int blocks_per_sm(int row_bytes) {
  const int smem = smem_bytes(row_bytes);
  int n = 0;
  if (cudaFuncSetAttribute(int8_tile_kernel<FILTER, SETS, Probe>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, int8_tile_kernel<FILTER, SETS, Probe>, THREADS, smem) !=
          cudaSuccess) {
    return -1;
  }
  return n;
}

// The accumulator sets of the shipped instance (tools/lowp_core_study.cu
// times both).
constexpr int SHIPPED_SETS = 1;

}  // namespace rht_int8

// Resident blocks on the current card at 128-byte rows (the planner's
// slots), or a negative value on failure.
extern "C" int scan_int8_slots() {
  const int sms = rht_scan::card_sms();
  const int n = rht_int8::blocks_per_sm<true, rht_int8::SHIPPED_SETS,
                                        rht_int8::NoProbe>(128);
  if (sms <= 0 || n <= 0) return -1;
  return n * sms;
}

// A block's dynamic shared memory, in bytes, at rows of row_bytes.
extern "C" int scan_int8_smem_bytes(int row_bytes) {
  return rht_int8::smem_bytes(row_bytes);
}

// Queries a block (the planner's query tile).
extern "C" int scan_int8_query_tile() { return rht_int8::TILE_Q; }

// q [B][row_bytes] and x [N][row_bytes] int8 (row_bytes a multiple of 16,
// at most MAX_ROW_BYTES), qscale [B], tscale [N], qq [B], sq [N] f32; q,
// x, tscale and sq 16-byte aligned.
// slabs: [splits][B][scan_topk_slab_len(k)] int2 and kshare [B] uint32
// scratch.
extern "C" int scan_int8_launch(const void* q, const void* x, const float* qq,
                                const float* qscale, const float* sq,
                                const float* tscale, int B, int N,
                                int row_bytes, int k, int splits, int2* slabs,
                                unsigned* kshare, float* out_s, int* out_i,
                                cudaStream_t stream) {
  return rht_int8::launch_form<true, rht_int8::SHIPPED_SETS,
                               rht_int8::NoProbe>(
      static_cast<const unsigned char*>(q),
      static_cast<const unsigned char*>(x), qq, qscale, sq, tscale, B, N,
      row_bytes, k, splits, slabs, kshare, out_s, out_i, stream);
}
