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
//   t's row terms and its drain vote under its own (SETS = 1;
//   hopper_ptx.cuh Scan::tiles). Two
//   accumulator sets (SETS = 2: tile t - 1 scored under tile t's MMAs)
//   need more than the 168 registers a thread of a 384-thread block gets
//   and spill; tools/lowp_core_study.cu times both.
// * The epilogue's common case is one add-max a score (see the filter
//   below): top = max(dot - beta(row)) per query, against alpha(query).
//   Rows past it are scored exactly, one a lane at a time, and admitted
//   strictly above the query's key.
// * Selection: kernel A's heaps, drain vote, splits' shared k-th best
//   and list_merge_kernel (scan_heap.cuh), in the frame both wgmma forms
//   share (hopper_ptx.cuh Frame, Scan, Launch: the producer, the tile
//   loop, the drains, the last sort and the launch).
//
// tools/lowp_core_study.cu times this form beside the general form, with
// the exact score of every row (FILTER = false) beside the filter, and
// where a block's cycles go; PERF.md has the numbers.
//
// C interface (ctypes, ops/cuda_scan.py): scan_int8_launch (returns a CUDA
// error code, cudaErrorInvalidValue for a shape or alignment the form
// cannot take, or cudaErrorNotSupported if a tensor map cannot be made),
// scan_int8_slots, scan_int8_smem_bytes and scan_int8_query_tile.

#include "hopper_ptx.cuh"

namespace rht_int8 {

using namespace rht_hopper;

// consumer warpgroups a block, each with its own 64 queries (the study
// builds others with -DRHT_INT8_CWG=n)
#ifndef RHT_INT8_CWG
#define RHT_INT8_CWG 2
#endif
// The form's own shared memory: three buffers of row terms (beta) and
// three of the rows' tscale and sq per consumer warpgroup (a tile's stage
// is refilled before its epilogue), then the warpgroups' reduction
// partials.
constexpr int BUFS = RHT_INT8_CWG * 3 * 128 * 4;  // a set of row buffers
constexpr int RED_BYTES = RHT_INT8_CWG * 4 * 8 * 4;
// The block's geometry (hopper_ptx.cuh Frame): two vectors a tile
// (tscale, sq).
using F = Frame<RHT_INT8_CWG, 4, 2, 3 * BUFS + RED_BYTES>;
constexpr int CWG = F::CWG;
constexpr int TILE_Q = F::TILE_Q;
constexpr int TILE_N = F::TILE_N;
constexpr int STAGES = F::STAGES;
constexpr int THREADS = F::THREADS;
constexpr int ACC = F::ACC;
constexpr int BETA_AT = F::CORE_AT;
constexpr int TSC_AT = BETA_AT + BUFS;  // tscale, sq copies
constexpr int RED_AT = TSC_AT + 2 * BUFS;
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
constexpr unsigned FULL = 0xffffffffu;

// Dynamic shared memory of a block.
__host__ __device__ constexpr int smem_bytes(int row_bytes) {
  return F::smem_bytes(row_bytes);
}

// -- the wgmma instruction -------------------------------------------------

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

// -- the kernel -------------------------------------------------------------

// Block (query tile, split) selects, per query, the top k of its split's
// rows into the (split, query) slab (hopper_ptx.cuh Scan). FILTER: the
// epilogue's filter (shipped); false: every score exact. SETS:
// accumulator sets a consumer warpgroup (2: it scores tile t - 1 while
// tile t's MMAs run; 1: the other warpgroup's MMAs run meanwhile). The
// study times each.
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
  Scan<F, Tune, Probe> blk(smem_raw, B, N, row_bytes, k, ntiles,
                           tiles_per_split, slab_len, slabs, kshare);
  if (blk.wg == CWG) {
    const CUtensorMap* const vmaps[2] = {&tsmap, &sqmap};
    blk.produce(&qmap, &xmap, vmaps);
  } else {
    blk.consumer();
    int* const nbeta_s = reinterpret_cast<int*>(blk.smem + BETA_AT);
    float* const tsc_s = reinterpret_cast<float*>(blk.smem + TSC_AT);
    float* const red_s = reinterpret_cast<float*>(blk.smem + RED_AT);
    const int wg = blk.wg, tw = blk.tw, warp = blk.warp, lane = blk.lane;
    const int tig = blk.tig, bar_id = blk.bar_id, q0 = blk.q0;
    const int t_begin = blk.t_begin;
    const int(&qb)[2] = blk.qb;
    const float(&key)[2] = blk.key;
    float qn[2], qsc[2], mu[2], cq[2];
    bool fin[2];  // mu and C finite: the filter's terms hold
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = q0 + qb[h] < B;
      qn[h] = live ? qq[q0 + qb[h]] : 0.f;
      qsc[h] = live ? qscale[q0 + qb[h]] : 1.f;
      mu[h] = __frcp_rn(2.f * qsc[h]);
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

    int alpha[2];              // the queries' filter terms, as last computed
    float a_lo = CUDART_NAN_F;  // ... under these ranges (none yet)
    float a_hi = CUDART_NAN_F;
    // After a drain: the keys' C and ranges, and alpha anew.
    bool drained = false;
    auto renew = [&]() RHT_INLINE {
      queries_changed();
      drained = true;
    };
    // Score finished tile t (accumulators acc, row terms of buffer bi made
    // under ranges brg) and append every row that beats its query's key.
    auto epilogue = [&](const int(&acc)[ACC], int t, int bi,
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
      blk.probe.mark(P_COMPARE);
      blk.probe.count(C_EPILOGUES, lane == 0);
      if (!any) return;
      blk.probe.count(C_SLOW, lane == 0);
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
          if (Probe::COUNTING) blk.probe.count(C_PASSED, has);
          rl[h] = 8 * (i >> 1) + 2 * tig + (i & 1);
          sc[h] = score(acc_pick(acc, h, i), qn[h], qsc[h],
                        tsc[TILE_N + rl[h]], tsc[rl[h]]);
          ok[h] = has && r0 + rl[h] < N && sc[h] > key[h];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (ok[h]) blk.append(h, sc[h], r0 + rl[h]);
        }
      }
      blk.probe.mark(P_ADMIT);
    };

    // Tile t's row terms into buffer (t - t_begin) % 3 (and its rows'
    // tscale and sq), from ring stage s, under the current ranges; on the
    // split's first tile, the block's reference row values first.
    auto row_terms = [&](int s, int t) RHT_INLINE {
      const float ts = blk.vec(s, 0)[tw], sqr = blk.vec(s, 1)[tw];
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
    auto mma = [](int(&d)[ACC], uint64_t a, uint64_t b,
                  int scale_d) RHT_INLINE { wgmma_s8(d, a, b, scale_d); };
    if constexpr (SETS == 2) {
      blk.wait_queries();
      const int t_end = blk.t_end, kch = blk.kch;
      int u = 0;  // units (tile, chunk) issued so far
      // Issue tile t's MMAs into cur (t < t_end) after its row terms
      // (their ranges kept in cur_rg); once its first chunk is in flight,
      // score tile t - 1 from prev. t == t_end only scores.
      auto step = [&](int(&cur)[ACC], Ranges& cur_rg, int(&prev)[ACC],
                      const Ranges& prev_rg, int t) RHT_INLINE {
        const bool issue = t < t_end;
        for (int c = 0; c < kch; ++c) {
          if (issue) {
            const int s = u % STAGES;
            mbar_wait(blk.full + s, (u / STAGES) & 1);
            blk.probe.mark(P_FULL_WAIT);
            if (c == 0) {
              row_terms(s, t);
              cur_rg = rg;
              blk.probe.mark(P_ROWS);
            }
            blk.issue(cur, s, c, mma);
            wgmma_wait<1>();  // unit u - 1 is done: its stage is free
            if (u > 0 && tw == 0) mbar_arrive(blk.empty + (u - 1) % STAGES);
            ++u;
          } else {
            wgmma_wait<0>();
          }
          acc_fence(prev);  // outside any branch: no warpgroup arrive
          blk.probe.mark(P_MMA);
          if (c == 0 && t > t_begin) {
            blk.drain_check(t - 1, renew);
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
      // One accumulator set (Scan::tiles): the tile's row terms and drain
      // vote run under its MMAs.
      Ranges brg;  // the ranges the current tile's row terms used
      int acc[ACC];
      blk.tiles(
          acc,
          [&](int s, int t) RHT_INLINE {
            row_terms(s, t);
            brg = rg;
          },
          mma,
          [&](const int(&a)[ACC], int t) RHT_INLINE {
            epilogue(a, t, (t - t_begin) % 3, brg);
          },
          renew);
    }
    blk.finish();
  }
}

// -- host side --------------------------------------------------------------

// Whether this form takes a shape: rows a multiple of 16 bytes and at
// most MAX_ROW_BYTES, the queries, the table, tscale and sq on 16-byte
// boundaries (a tensor map's terms).
inline bool takes(const void* q, const void* x, const float* sq,
                  const float* tscale, int row_bytes) {
  return row_bytes <= MAX_ROW_BYTES &&
         map_takes(row_bytes, {q, x, sq, tscale});
}

template <bool FILTER, int SETS, class Probe, class Tune = Tuning>
int launch_form(const unsigned char* q, const unsigned char* x,
                const float* qq, const float* qscale, const float* sq,
                const float* tscale, int B, int N, int row_bytes, int k,
                int splits, int2* slabs, unsigned* kshare, float* out_s,
                int* out_i, cudaStream_t stream) {
  if (B <= 0 || k <= 0) return 0;
  const Launch<F> L(B, N, row_bytes, k, splits);
  if (!qscale || !tscale || !L.takes(N, splits) ||
      !takes(q, x, sq, tscale, row_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap qmap, xmap, tsmap, sqmap;
  if (!byte_map(q, B, row_bytes, TILE_Q, &qmap) ||
      !byte_map(x, N, row_bytes, TILE_N, &xmap) ||
      !float_map(tscale, N, TILE_N, &tsmap) ||
      !float_map(sq, N, TILE_N, &sqmap)) {
    return (int)cudaErrorNotSupported;
  }
  auto* const kernel = int8_tile_kernel<FILTER, SETS, Probe, Tune>;
  const int err = L.prepare(kernel, B, kshare, stream);
  if (err != 0) return err;
  kernel<<<L.grid, THREADS, L.smem, stream>>>(
      qmap, xmap, tsmap, sqmap, qq, qscale, B, N, row_bytes, k, L.ntiles,
      L.tiles_per_split, L.slab_len, slabs, kshare);
  return L.finish(slabs, B, k, splits, out_s, out_i, stream);
}

template <bool FILTER, int SETS, class Probe>
int blocks_per_sm(int row_bytes) {
  return resident_blocks<F>(int8_tile_kernel<FILTER, SETS, Probe>,
                            row_bytes);
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
