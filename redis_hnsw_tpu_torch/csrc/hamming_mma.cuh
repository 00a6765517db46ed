// The int8 tensor-core core of kernel A′ (the exact hamming top-k,
// scan_topk.cu hamming_tile_kernel): the block tile's shape, the ring of
// row words (load_words) and MmaCore, whose products give popcount(q) -
// popcount(q XOR x) per (query, row). Hamming counts are exact integers,
// so any other unit that counts them (the certified tier's count scores
// on the b1 tensor-core product) agrees with these by arithmetic.

#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "l2_core.cuh"

namespace rht_ham {

using rht_l2::cp_async;

constexpr int TILE = 128;     // queries, and rows, per block tile
constexpr int THREADS = 128;  // one owned query per thread
constexpr int WC = 8;         // words per pipeline stage
constexpr int STAGES = 3;
constexpr int STAGE_WORDS = TILE * WC;
constexpr unsigned SPREAD = 0x01010101u;

static_assert(THREADS == TILE, "one owned query and one staged row a thread");

// The int8 tensor-core core. Bit j of word w is k index 32w + kappa(j):
// byte 4c + i of a word's 32-byte k block holds bit c + 8i (c < 8, i <
// 4), a permutation of the JAX package's pm1_table order under which a
// fragment register is (word >> c) & 0x01010101 -- dot products do not
// depend on the order of k. The queries are the A operand as +-1 bytes,
// expanded once per word chunk into shared memory and read with
// ldmatrix; the rows are the B operand as 0/1 bytes, expanded in
// registers from the staged words. Then
//   dot = sum over set row bits of (+-1) = 2 popc(q & x) - popc(x),
//   popc(q ^ x) = popc(q) + popc(x) - 2 popc(q & x) = popc(q) - dot,
// exact in int32 (|dot| <= 32W). Padding words and queries expand to 0
// bytes and add nothing; padding rows are masked by id.
//
// Warp w computes rows 32w .. 32w + 31 of the 128 x 128 tile against all
// 128 queries: 8 m16 query tiles x 4 n8 row tiles of m16n8k32 products,
// 128 int32 accumulators a thread. A word costs a warp 32 mma, 8
// ldmatrix.x4 and 8 two-instruction B expansions.
struct MmaCore {
  static constexpr int QS_BYTES = WC * TILE * 32;  // [word][query][32 B]
  static constexpr int NEVER = INT_MAX;
  // a block merges its buffers before a tile's appends once one holds
  // more than DRAIN_AT entries (at most BUF_CAP - TILE: a tile must fit).
  // Early merges keep the keys fresh, so fewer rows are appended.
  static constexpr int DRAIN_AT = 16;
  struct Acc {
    int c[8][4][4];
  };

  // Admission keys: a query admits a row iff its count is below `lim`,
  // i.e. iff dot > popc(q) - lim.
  __device__ static int key(int popcq, int lim) { return popcq - lim; }
  __device__ static int count(int v, int popcq) { return popcq - v; }

  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc.c[m][n][e] = 0;
  }

  // 0/1 bytes -> +1/-1 bytes (0x01 / 0xFF): ~(b * 0xFE), no carries.
  __device__ static unsigned pm1(unsigned b) { return ~(b * 0xFEu); }

  // Expand words [w0, w0 + wn) of the tile's queries into qs: query ql's
  // 32-byte block of word j at j * TILE * 32 + ql * 32, its two 16-byte
  // halves swapped on queries with bit 2 set, so that ldmatrix's 8-row
  // reads hit 32 distinct banks. Called by all threads, which then sync.
  __device__ static void stage(unsigned char* qs, const int* __restrict__ Q,
                               int B, int W, int q0, int w0, int wn) {
    const int ql = threadIdx.x;
    const int q = q0 + ql;
    const int sw = ((ql >> 2) & 1) * 16;
#pragma unroll
    for (int j = 0; j < WC; ++j) {
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (q < B && j < wn) {
        const unsigned x = (unsigned)__ldg(Q + (size_t)q * W + w0 + j);
        lo = make_uint4(pm1(x & SPREAD), pm1((x >> 1) & SPREAD),
                        pm1((x >> 2) & SPREAD), pm1((x >> 3) & SPREAD));
        hi = make_uint4(pm1((x >> 4) & SPREAD), pm1((x >> 5) & SPREAD),
                        pm1((x >> 6) & SPREAD), pm1((x >> 7) & SPREAD));
      }
      unsigned char* dst = qs + j * TILE * 32 + ql * 32;
      *reinterpret_cast<uint4*>(dst + sw) = lo;
      *reinterpret_cast<uint4*>(dst + (16 ^ sw)) = hi;
    }
  }

  __device__ static unsigned word_of(const int4& h, int j) {
    return (unsigned)(j == 0 ? h.x : j == 1 ? h.y : j == 2 ? h.z : h.w);
  }

  // acc += the products of the staged query words and the row words xs
  // ([TILE][WC], one ring stage) over words 0 .. wn - 1 of the chunk.
  __device__ static void chunk(const unsigned char* qs, const int* xs, int wn,
                               Acc& acc) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int tig = lane % 4;
    // ldmatrix.x4: lanes 8m .. 8m + 7 address matrix m, which is rows
    // (m & 1) * 8 .. + 7 of a 16-query tile and 16-byte half m >> 1
    const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
    const unsigned base =
        (unsigned)__cvta_generic_to_shared(qs) + r * 32 +
        (((lane >> 4) ^ ((r >> 2) & 1)) * 16);
#pragma unroll
    for (int j0 = 0; j0 < WC; j0 += 4) {
      if (j0 >= wn) break;
      int4 xw[4];  // words j0 .. j0 + 3 of this lane's row of each n tile
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        xw[n] = reinterpret_cast<const int4*>(
            xs + (warp * 32 + n * 8 + g) * WC)[j0 / 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j0 + j >= wn) break;
        // the word's 8 A fragments first, so their loads overlap
        unsigned a[8][4];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
              "[%4];\n"
              : "=r"(a[m][0]), "=r"(a[m][1]), "=r"(a[m][2]), "=r"(a[m][3])
              : "r"(base + (j0 + j) * TILE * 32 + m * 16 * 32)
              : "memory");
        }
        unsigned b0[4], b1[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const unsigned x = word_of(xw[n], j);
          b0[n] = (x >> tig) & SPREAD;        // k = 4 tig + i: bit tig + 8i
          b1[n] = (x >> (tig + 4)) & SPREAD;  // k + 16: bit tig + 4 + 8i
        }
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            int* c = acc.c[m][n];
            asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
                "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                "{%0, %1, %2, %3};\n"
                : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
                : "r"(a[m][0]), "r"(a[m][1]), "r"(a[m][2]), "r"(a[m][3]),
                  "r"(b0[n]), "r"(b1[n]));
          }
      }
    }
  }

  // Append every accumulator that passes its query's key (keys and
  // append counters: [TILE] in shared memory) on a live row (live(row)),
  // as emit(query, row, acc, slot); zeroes the accumulators. Element e of
  // tile (m, n) is query 16m + g + 8(e / 2), row 32 warp + 8n + 2 tig +
  // e % 2, so the 4 lanes 4g .. 4g + 3 hold a query's 32 rows of the
  // warp: for each (m, h), query 16m + g + 8h, the group of lanes with
  // the same g. A query's survivors of the warp are appended together:
  // each lane tests its 8 counts into a mask, branch-free; the 4 lanes
  // prefix-sum their survivor counts by shuffles, one of them reserves
  // the slots with one shared atomic, and each lane writes its survivors
  // in a rolled loop. G (m, h) pairs go through these steps side by side,
  // so that their latencies overlap, behind one warp vote: survivors are
  // rare once the heaps fill, and a warp with none skips the rest.
  template <int G = 4, class Live, class Emit>
  __device__ static void each(Acc& acc, const int* key_s, int* cnt_s,
                              Live&& live, Emit&& emit) {
    constexpr unsigned FULL = 0xffffffffu;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int tig = lane % 4;
    const int row0 = warp * 32 + 2 * tig;  // bit j of a mask: + 8(j/2) + j%2
    unsigned live8 = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      live8 |= (unsigned)live(row0 + 8 * (j / 2) + j % 2) << j;
    }
#pragma unroll
    for (int mh0 = 0; mh0 < 16; mh0 += G) {
      unsigned mask[G];
      unsigned any = 0;
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int m = (mh0 + u) / 2, h = (mh0 + u) % 2;
        const int key = key_s[16 * m + g + 8 * h];
        unsigned mk = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mk |= (unsigned)(acc.c[m][j / 2][2 * h + j % 2] > key) << j;
        }
        mask[u] = mk & live8;
        any |= mask[u];
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
        for (unsigned b = mask[u]; b; b &= b - 1) {
          const int j = __ffs(b) - 1;
          int v = acc.c[m][0][2 * h];
#pragma unroll
          for (int w = 1; w < 8; ++w) {
            v = j == w ? acc.c[m][w / 2][2 * h + w % 2] : v;
          }
          emit(16 * m + g + 8 * h, row0 + 8 * (j / 2) + j % 2, v,
               slot[u]++);
        }
      }
    }
    zero(acc);
  }
};

// Start copying words [w0, w0 + WC) of table rows r0 .. r0 + TILE - 1
// into one ring stage ([TILE][WC]); zeros past N and W. VEC = 4 needs
// W % 4 == 0 and an aligned table, so a 16-byte copy is wholly inside or
// wholly outside W.
template <int VEC>
__device__ __forceinline__ void load_words(int* stage,
                                           const int* __restrict__ X, int N,
                                           int W, int r0, int w0) {
  constexpr int PER_ROW = WC / VEC;
  constexpr int ROWS_PER_PASS = THREADS / PER_ROW;
  const int col = threadIdx.x % PER_ROW;
  const int w = w0 + col * VEC;
#pragma unroll
  for (int p = 0; p < TILE / ROWS_PER_PASS; ++p) {
    const int r = threadIdx.x / PER_ROW + p * ROWS_PER_PASS;
    const bool ok = r0 + r < N && w < W;
    cp_async<VEC>(reinterpret_cast<float*>(stage + r * WC + col * VEC),
                  reinterpret_cast<const float*>(
                      ok ? X + (size_t)(r0 + r) * W + w : X),
                  ok ? 4 * VEC : 0);
  }
}

}  // namespace rht_ham
