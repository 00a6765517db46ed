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
// integers, exact on any unit, so they agree by arithmetic: A′ sums them
// on its int8 core (hamming_mma.cuh), B′ on the b1 tensor-core product
// of the packed words, below.
//
// Bound on the H100: (B/16)(N/8) ceil(W/8) b1 products, at the rate of
// the dense int8 products of the same m16n8 shape (tools/b1_mma_probe.cu
// measured both forms at one product rate on the card, 1.56e11 a second
// -- and the b1 .xor.popc form at a sixth of it); 0.061 ms at B = 2048,
// N = 1,000,064, W = 8 at the card's clock, above the (B + N) W 4 bytes'
// 0.011 ms and below the 2.05e9 scores' epilogue: one integer operation a
// score is 0.122 ms on the CUDA cores. So the design makes the common
// case half an operation a score and feeds the tensor cores the words as
// they are:
//
// * The core: mma.sync m16n8k256 .and.popc on the packed words, nothing
//   expanded. k-chunk j (32 bits) of a 256-bit step is word 2j of the
//   step for j < 4 and word 2(j - 4) + 1 for j >= 4, so lane (g, tig)'s two
//   B registers are words 2 tig, 2 tig + 1 of row g -- one 8-byte shared
//   load, a warp's loads 256 contiguous bytes -- and its A registers the
//   same words of its queries g and g + 8. Words past W are zeros in
//   both operands and add nothing, so one form takes every W and N.
// * count = popc(q ^ x) = popc(q) + rt - 2 popc(q & x), rt = popc(x) (BIG
//   on a dead row or a row past the block's rows), computed once a stage.
//   The product starts from -(rt >> 1) on its row (the mma's C operand),
//   so it gives D = popc(q & x) - (rt >> 1) and count = popc(q) + (rt &
//   1) - 2D, with popc(q) folded into the query's keys: > iff v < gk, ==
//   iff v == ek for v = (rt & 1) - 2D (thresholds below).
// * The filter, one three-input max for two scores: per (thread, query)
//   the greatest D over the thread's rows (__vimax3_s32). A row that
//   passes has v <= f = max(gk - 1, ek), so D >= kf = -floor(f / 2); at the
//   end of a stage, a greatest D >= kf sends the warp's 16-query tile
//   through the exact compare-and-count: its products recomputed from
//   the stage in shared memory, the counts summed over the 4 lanes of a
//   query and added to the query's shared counters. With t the k-th best
//   of a million rows that is rare (rows one count past the threshold
//   pass the filter too); the maxima are reset only after it runs.
// * Feed: each warp streams its own stages of R rows (64 at W <= 8, so a
//   stage is 2 KB of words; 512 words a stage for wider rows, at least 8
//   rows) through its own 3-stage cp.async ring (16-byte copies, or 4-byte
//   ones for a table off a 16-byte boundary or W % 4 != 0, zeros past the
//   rows and W), with each row's bias: no block barrier in the loop. For
//   W <= 8 a warp keeps the block's 128 queries' A fragments in registers
//   for its whole split; wider rows loop over 256-bit chunks, their query
//   words staged in shared memory once a block (up to 64 words; past it
//   read through the L1 cache).
// * Each thread also counts the dead rows (< N, bias -inf) of its stages:
//   the block's dead rows count as == for the queries whose t is -inf.
// * At the end, thread q adds query q's shared counts into c_gt and c_eq
//   with integer atomics, once per (block, query): exact, whatever the
//   order. ops/cuda_count_hamming.py plans the splits from the card's
//   resident blocks of this kernel at the launch's W
//   (count_hamming_slots), so that the blocks fill whole waves.
//
// Shared memory: per query its filter key, two keys and two counters
// (2,560 B), the dead-row count, per warp 3 stages of words (2,048 B each
// up to W = 64), bias and the two row terms (768 B); wide rows' staged
// queries (4,096 B a 256-bit chunk): 36,368 B a block at W <= 8
// (count_hamming_smem_bytes), 69,136 B at W = 64; the launch takes W <=
// 512.
//
// C interface (ctypes, ops/cuda_count_hamming.py): count_hamming_launch
// (c_gt and c_eq zeroed by the caller; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take),
// count_hamming_slots(W) and count_hamming_smem_bytes.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "l2_core.cuh"

// The kernel's parts are lambdas over its state; each is inlined, so the
// fragments and accumulators stay in registers.
#define RHT_HC_INLINE __attribute__((always_inline))

namespace rht_hcount {

using rht_l2::cp_async;
using rht_l2::cp_async_commit;
using rht_l2::cp_async_wait;

// Study knobs (tools/count_hamming_study.py builds others): each warp's
// ring depth, rows a stage at W <= 8, resident blocks an SM asked of
// ptxas, n8 tiles unrolled together, and which parts of a stage run (0:
// all; 1: the products and a one-op fold, no filter; 3: no popcounts --
// every row takes the dead term, so nothing passes; 4: the products
// start from 0, not from the row term, no filter check; 5: no filter
// check -- 1, 3, 4 and 5 give wrong counts, for timing only).
#ifndef RHT_HC_STAGES
#define RHT_HC_STAGES 3
#endif
#ifndef RHT_HC_ROWS
#define RHT_HC_ROWS 64
#endif
#ifndef RHT_HC_MINB
#define RHT_HC_MINB 4
#endif
#ifndef RHT_HC_PART
#define RHT_HC_PART 0
#endif
#ifndef RHT_HC_UNROLL  // n8 tiles of a stage unrolled together
#define RHT_HC_UNROLL 4
#endif
#define RHT_HC_STR(x) #x
#define RHT_HC_UNROLL_BY(n) _Pragma(RHT_HC_STR(unroll n))

constexpr int QT = 128;      // queries a block: 8 m16 tiles
constexpr int TILE = 128;    // rows of the planner's tile (plan_tiles)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = RHT_HC_STAGES;  // each warp's ring
constexpr int R_MAX = RHT_HC_ROWS;     // rows a stage at W <= 8
constexpr int QS_CHUNKS = 8;  // wide rows up to 64 words: queries staged
constexpr int MAX_W = 512;   // words a row the launch takes
constexpr int BIG = 1 << 24;  // a dead row's term: never passes
constexpr int NEVER = INT_MIN;
constexpr unsigned FULL = 0xffffffffu;
constexpr int HEAD_BYTES = (5 * QT + 4) * 4;

static_assert(THREADS == QT, "thread q sets query q's keys");

// Rows a stage over nch 256-bit chunks: R_MAX at one chunk, fewer for
// wider rows so that a stage stays R_MAX * 8 words, at least 8 (one n8
// tile).
__host__ __device__ constexpr int stage_rows(int nch) {
  return (R_MAX / nch) / 8 * 8 > 8 ? (R_MAX / nch) / 8 * 8 : 8;
}

__host__ __device__ constexpr int stage_words(int nch) {
  return stage_rows(nch) * 8 * nch > R_MAX * 8 ? stage_rows(nch) * 8 * nch
                                                : R_MAX * 8;
}

// Shared memory a block at W words a row: the queries' keys and counts;
// wide rows' staged queries ([chunk][query][8 words]); per warp its ring
// of words, bias and the rows' two terms.
constexpr int smem_bytes(int W) {
  return HEAD_BYTES +
         (W > 8 && (W + 7) / 8 <= QS_CHUNKS ? (W + 7) / 8 * QT * 32 : 0) +
         WARPS * STAGES * (stage_words((W + 7) / 8) * 4 + 3 * R_MAX * 4);
}

// A live row of count c is > th iff c < *lim, == th iff c == *eqc (-1:
// none): t = -inf makes every live row >, t = +inf or NaN none.
__device__ __forceinline__ void thresholds(float th, int W, int* lim,
                                           int* eqc) {
  const float x = -th;  // a live row of count c: > th iff c < x
  const int top = 32 * W;
  *lim = 0;
  *eqc = -1;
  if (x != x) {  // NaN: nothing compares
  } else if (x > (float)top) {
    *lim = top + 1;
  } else if (x >= 0.f) {
    *lim = (int)ceilf(x);
    if (floorf(x) == x) *eqc = (int)x;
  }
}

// d = popc(A & B) over one 256-bit step plus c = (c.x, c.y) on the
// fragment's two rows; or d += popc(A & B).
__device__ __forceinline__ void mma_init(int (&d)[4], const unsigned (&a)[4],
                                         int2 b, int2 c) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y),
        "r"(c.x), "r"(c.y), "r"(c.x), "r"(c.y));
}

__device__ __forceinline__ void mma_more(int (&d)[4], const unsigned (&a)[4],
                                         int2 b) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Lane (g, tig)'s A fragment of the 16 queries from q (chunk c) from the
// queries in device memory: words 2 tig and 2 tig + 1 of the chunk for
// queries q + g and q + g + 8; zeros past B and W.
__device__ __forceinline__ void frag_a(const int* __restrict__ Q, int B,
                                       int W, int q, int c, int g, int tig,
                                       unsigned (&a)[4]) {
  const int w = 8 * c + 2 * tig;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qq = q + g + 8 * h;
    const int* p = Q + (size_t)qq * W + w;
    a[h] = qq < B && w < W ? (unsigned)__ldg(p) : 0u;
    a[2 + h] = qq < B && w + 1 < W ? (unsigned)__ldg(p + 1) : 0u;
  }
}

template <int VEC, bool WIDE>
__global__ void __launch_bounds__(THREADS, RHT_HC_MINB)
    count_hamming_kernel(const int* __restrict__ Q, const int* __restrict__ X,
                         const float* __restrict__ bias,
                         const float* __restrict__ thr, int B, int N, int W,
                         int tiles_per_split, int* __restrict__ c_gt,
                         int* __restrict__ c_eq) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* const kf_s = reinterpret_cast<int*>(smem);
  int* const gk_s = kf_s + QT;
  int* const ek_s = gk_s + QT;
  int* const gt_s = ek_s + QT;
  int* const eq_s = gt_s + QT;
  int* const dead_s = eq_s + QT;

  const int nch = WIDE ? (W + 7) / 8 : 1;
  const bool staged = WIDE && nch <= QS_CHUNKS;
  const int R = stage_rows(nch);
  const int SW = stage_words(nch);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  int* const qs = reinterpret_cast<int*>(smem + HEAD_BYTES);
  int* const words_all = qs + (staged ? nch * QT * 8 : 0);
  float* const bias_all =
      reinterpret_cast<float*>(words_all + WARPS * STAGES * SW);
  int* const nh_all = reinterpret_cast<int*>(bias_all + WARPS * STAGES * R_MAX);
  int* const par_all = nh_all + WARPS * STAGES * R_MAX;
  int* const words_w = words_all + warp * STAGES * SW;
  float* const bias_w = bias_all + warp * STAGES * R_MAX;
  int* const nh_w = nh_all + warp * STAGES * R_MAX;
  int* const par_w = par_all + warp * STAGES * R_MAX;

  // Thread tid: query q0 + tid's keys. With v = count - popc(q) a row is
  // > iff v < gk, == iff v == ek, and passes neither unless v <= f; as
  // v = p - 2D below (D = popc(q & x) - (popc(x) >> 1), p = popc(x) & 1),
  // it then has D >= kf = -floor(f / 2). Past B: kf = 1, and D <= 0.
  const int q0 = blockIdx.x * QT;
  const int q = q0 + tid;
  float th = CUDART_INF_F;
  int popcq = 0;
  if (q < B) th = thr[q];
  for (int w = 0; w < (WIDE ? 8 * nch : W); ++w) {
    const int word = q < B && w < W ? __ldg(Q + (size_t)q * W + w) : 0;
    popcq += __popc(word);
    if (staged) qs[((w / 8) * QT + tid) * 8 + w % 8] = word;
  }
  int lim, eqc;
  thresholds(th, W, &lim, &eqc);
  const int gk = lim - popcq;
  const int ek = eqc < 0 ? NEVER : eqc - popcq;
  gk_s[tid] = gk;
  ek_s[tid] = ek;
  kf_s[tid] = -(max(gk - 1, ek) >> 1);
  gt_s[tid] = 0;
  eq_s[tid] = 0;
  if (tid == 0) *dead_s = 0;
  __syncthreads();

  // pair mh = 2m + h: query 16m + g + 8h
  int top[16];
#pragma unroll
  for (int mh = 0; mh < 16; ++mh) top[mh] = INT_MIN;
  unsigned a[8][4];
  if constexpr (!WIDE) {
#pragma unroll
    for (int m = 0; m < 8; ++m) frag_a(Q, B, W, q0 + 16 * m, 0, g, tig, a[m]);
  }
  // wide rows: m tile m's A fragment of chunk c
  auto frag = [&](int m, int c, unsigned (&am)[4]) RHT_HC_INLINE {
    if (staged) {
      const int* const p = qs + (c * QT + 16 * m + g) * 8 + 2 * tig;
      const int2 lo = *reinterpret_cast<const int2*>(p);
      const int2 hi = *reinterpret_cast<const int2*>(p + 64);
      am[0] = lo.x;
      am[1] = hi.x;
      am[2] = lo.y;
      am[3] = hi.y;
    } else {
      frag_a(Q, B, W, q0 + 16 * m, c, g, tig, am);
    }
  };

  // this block's rows, in stages of R; warp w takes stages w, w + 4, ...
  const int r_begin = blockIdx.y * tiles_per_split * TILE;
  const int r_end = min(N, r_begin + tiles_per_split * TILE);
  const int stages = r_end > r_begin ? (r_end - r_begin + R - 1) / R : 0;
  const int mine = stages > warp ? (stages - warp + WARPS - 1) / WARPS : 0;

  // stage s's words ([chunk][row][8 words]) and bias; zeros past r_end, W
  auto load = [&](int s) RHT_HC_INLINE {
    const int r0 = r_begin + (warp + s * WARPS) * R;
    int* const dst = words_w + (s % STAGES) * SW;
    const int per_row = (8 / VEC) * nch;
    const int pieces = R * per_row;
    for (int p = lane; p < pieces; p += 32) {
      const int r = p / per_row;
      const int w = (p % per_row) * VEC;
      const bool ok = r0 + r < r_end && w < W;
      cp_async<VEC>(
          reinterpret_cast<float*>(dst + ((w / 8) * R + r) * 8 + w % 8),
          reinterpret_cast<const float*>(ok ? X + (size_t)(r0 + r) * W + w
                                            : X),
          ok ? 4 * VEC : 0);
    }
    float* const bdst = bias_w + (s % STAGES) * R_MAX;
    for (int r = lane; r < R; r += 32) {
      const bool ok = r0 + r < r_end;
      cp_async<1>(bdst + r, ok ? bias + r0 + r : bias, ok ? 4 : 0);
    }
  };

  // d[m] = popc(q & x) - (popc(x) >> 1) of n8 tile n of the stage at ws
  // (row terms nhs), all 8 m tiles, or m tile m alone
  auto score = [&](const int* ws, const int* nhs, int n, int m0, int m1,
                   int (&d)[8][4]) RHT_HC_INLINE {
    const int* const xs = ws + (8 * n + g) * 8 + 2 * tig;
    const int2 nh = *reinterpret_cast<const int2*>(nhs + 8 * n + 2 * tig);
    const int2 b = *reinterpret_cast<const int2*>(xs);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      if (m < m0 || m >= m1) continue;
      if constexpr (WIDE) frag(m, 0, a[m]);
#if RHT_HC_PART == 4
      mma_init(d[m], a[m], b, make_int2(0, 0));
#else
      mma_init(d[m], a[m], b, nh);
#endif
    }
    for (int c = 1; c < nch; ++c) {
      const int2 bc = *reinterpret_cast<const int2*>(xs + c * R * 8);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        if (m < m0 || m >= m1) continue;
        frag(m, c, a[m]);
        mma_more(d[m], a[m], bc);
      }
    }
  };

  // The exact compare-and-count of m tile m over the stage at ws.
  auto exact = [&](const int* ws, const int* nhs, const int* pars,
                   int m) RHT_HC_INLINE {
    const int ql = 16 * m + g;
    const int gk0 = gk_s[ql], gk1 = gk_s[ql + 8];
    const int ek0 = ek_s[ql], ek1 = ek_s[ql + 8];
    int cg0 = 0, cg1 = 0, ce0 = 0, ce1 = 0;
    for (int n = 0; n < R / 8; ++n) {
      int d[8][4];
      score(ws, nhs, n, m, m + 1, d);
      const int2 p = *reinterpret_cast<const int2*>(pars + 8 * n + 2 * tig);
      const int v0 = p.x - 2 * d[m][0], v1 = p.y - 2 * d[m][1];
      const int v2 = p.x - 2 * d[m][2], v3 = p.y - 2 * d[m][3];
      cg0 += (v0 < gk0) + (v1 < gk0);
      ce0 += (v0 == ek0) + (v1 == ek0);
      cg1 += (v2 < gk1) + (v3 < gk1);
      ce1 += (v2 == ek1) + (v3 == ek1);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      cg0 += __shfl_xor_sync(FULL, cg0, off);
      cg1 += __shfl_xor_sync(FULL, cg1, off);
      ce0 += __shfl_xor_sync(FULL, ce0, off);
      ce1 += __shfl_xor_sync(FULL, ce1, off);
    }
    if (tig == 0) {
      if (cg0) atomicAdd(&gt_s[ql], cg0);
      if (cg1) atomicAdd(&gt_s[ql + 8], cg1);
      if (ce0) atomicAdd(&eq_s[ql], ce0);
      if (ce1) atomicAdd(&eq_s[ql + 8], ce1);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < mine) load(s);
    cp_async_commit();
  }
  int dead = 0;  // dead rows (< N, bias -inf) of this lane's row terms
  for (int s = 0; s < mine; ++s) {
    cp_async_wait<STAGES - 2>();  // stage s has landed (this lane's part)
    __syncwarp();  // ... the warp's; and stage s - 1's slot is free
    if (s + STAGES - 1 < mine) load(s + STAGES - 1);
    cp_async_commit();
    const int slot = s % STAGES;
    const int r0 = r_begin + (warp + s * WARPS) * R;
    const int* const ws = words_w + slot * SW;
    const float* const bs = bias_w + slot * R_MAX;
    int* const nhs = nh_w + slot * R_MAX;
    int* const pars = par_w + slot * R_MAX;

    // the row terms of rt = popc(x) on a live row, BIG on a dead one or
    // past r_end: -(rt >> 1) (the products' initial value) and rt & 1
    for (int r = lane; r < R; r += 32) {
      int rt = BIG;
      if (RHT_HC_PART == 3) {
      } else if (r0 + r < r_end) {
        if (bs[r] == -CUDART_INF_F) {
          ++dead;
        } else {
          rt = 0;
          for (int c = 0; c < nch; ++c) {
            const int4* p = reinterpret_cast<const int4*>(ws + (c * R + r) * 8);
            const int4 u = p[0], v = p[1];
            rt += __popc(u.x) + __popc(u.y) + __popc(u.z) + __popc(u.w) +
                  __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
          }
        }
      }
      nhs[r] = -(rt >> 1);
      pars[r] = rt & 1;
    }
    __syncwarp();

    // score every n8 tile; keep per (thread, query) the greatest D (wide
    // rows one tile at a time: their fragments are reloaded per chunk)
    auto tile = [&](int n) RHT_HC_INLINE {
      int d[8][4];
      score(ws, nhs, n, 0, 8, d);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
#if RHT_HC_PART == 1
        top[2 * m] ^= d[m][0];
        top[2 * m + 1] ^= d[m][2];
#else
        top[2 * m] = __vimax3_s32(top[2 * m], d[m][0], d[m][1]);
        top[2 * m + 1] = __vimax3_s32(top[2 * m + 1], d[m][2], d[m][3]);
#endif
      }
    };
    if constexpr (WIDE) {
#pragma unroll 1
      for (int n = 0; n < R / 8; ++n) tile(n);
    } else {
      RHT_HC_UNROLL_BY(RHT_HC_UNROLL)
      for (int n = 0; n < R / 8; ++n) tile(n);
    }
#if RHT_HC_PART == 1 || RHT_HC_PART == 4 || RHT_HC_PART == 5
    if (s + 1 == mine) {
#pragma unroll
      for (int mh = 0; mh < 16; ++mh) atomicAdd(&gt_s[mh], top[mh]);
    }
    continue;
#endif

    // the filter: m tiles where a lane's greatest D may pass count exactly
    unsigned fired = 0;
#pragma unroll
    for (int mh = 0; mh < 16; ++mh) {
      fired |= (unsigned)(top[mh] >= kf_s[16 * (mh / 2) + g + 8 * (mh % 2)])
               << (mh / 2);
    }
    fired = __reduce_or_sync(FULL, fired);
    if (fired) {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        if (fired >> m & 1) exact(ws, nhs, pars, m);
      }
#pragma unroll
      for (int mh = 0; mh < 16; ++mh) top[mh] = INT_MIN;
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (an empty split)

  dead = __reduce_add_sync(FULL, dead);
  if (lane == 0 && dead) atomicAdd(dead_s, dead);
  __syncthreads();
  if (q < B) {
    const int gt = gt_s[tid];
    const int eq = eq_s[tid] + (th == -CUDART_INF_F ? *dead_s : 0);
    if (gt) atomicAdd(&c_gt[q], gt);
    if (eq) atomicAdd(&c_eq[q], eq);
  }
}

template <int VEC, bool WIDE>
cudaError_t allow_smem(int bytes) {
  return cudaFuncSetAttribute(count_hamming_kernel<VEC, WIDE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int VEC, bool WIDE>
int blocks_per_sm(int bytes) {
  int n = 0;
  if (allow_smem<VEC, WIDE>(bytes) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, count_hamming_kernel<VEC, WIDE>, THREADS, bytes) !=
      cudaSuccess) {
    return -1;
  }
  return n;
}

template <int VEC, bool WIDE>
cudaError_t launch(dim3 grid, int smem, cudaStream_t stream, const int* q,
                   const int* x, const float* bias, const float* t, int B,
                   int N, int W, int tiles_per_split, int* c_gt, int* c_eq) {
  const cudaError_t err = allow_smem<VEC, WIDE>(smem);
  if (err != cudaSuccess) return err;
  count_hamming_kernel<VEC, WIDE><<<grid, THREADS, smem, stream>>>(
      q, x, bias, t, B, N, W, tiles_per_split, c_gt, c_eq);
  return cudaGetLastError();
}

}  // namespace rht_hcount

// Resident blocks of kernel B′ the current card holds at once at rows of
// W words (the fewer of the two copy forms that W takes), or a negative
// value on failure.
extern "C" int count_hamming_slots(int W) {
  using namespace rht_hcount;
  int dev = 0, sms = 0;
  if (W < 1 || W > MAX_W || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return -1;
  }
  const int bytes = smem_bytes(W);
  const int a = W <= 8 ? blocks_per_sm<4, false>(bytes)
                       : blocks_per_sm<4, true>(bytes);
  const int b = W <= 8 ? blocks_per_sm<1, false>(bytes)
                       : blocks_per_sm<1, true>(bytes);
  if (a <= 0 || b <= 0) return -1;
  return (a < b ? a : b) * sms;
}

// The dynamic shared memory of one block at rows of up to 8 words (the
// main path's), in bytes.
extern "C" int count_hamming_smem_bytes() { return rht_hcount::smem_bytes(8); }

// bias is 0 on a live row and -inf on a dead one.
extern "C" int count_hamming_launch(const int* q, const int* x,
                                    const float* bias, const float* t, int B,
                                    int N, int W, int splits, int* c_gt,
                                    int* c_eq, cudaStream_t stream) {
  using namespace rht_hcount;
  if (B <= 0 || N <= 0) return 0;
  const int ntiles = (N + TILE - 1) / TILE;
  if (W < 1 || W > MAX_W || splits < 1 || splits > ntiles ||
      splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_per_split = (ntiles + splits - 1) / splits;
  const dim3 grid((B + QT - 1) / QT, splits);
  const int smem = smem_bytes(W);
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err;
  if (W <= 8) {
    err = vec4 ? launch<4, false>(grid, smem, stream, q, x, bias, t, B, N, W,
                                  tiles_per_split, c_gt, c_eq)
               : launch<1, false>(grid, smem, stream, q, x, bias, t, B, N, W,
                                  tiles_per_split, c_gt, c_eq);
  } else {
    err = vec4 ? launch<4, true>(grid, smem, stream, q, x, bias, t, B, N, W,
                                 tiles_per_split, c_gt, c_eq)
               : launch<1, true>(grid, smem, stream, q, x, bias, t, B, N, W,
                                 tiles_per_split, c_gt, c_eq);
  }
  return (int)err;
}
