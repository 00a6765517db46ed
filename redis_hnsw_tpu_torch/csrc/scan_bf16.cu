// Kernel A-bf16, the Hopper form: the bf16 scan tier's select on warpgroup
// MMA, with TMA-fed row tiles and the query tile resident in shared memory.
//
// The JAX package scores this tier in XLA (redis_hnsw_tpu/ops/scan.py
// _chunk_scores, :171-172: a bf16 jnp.dot with f32 out, then lax.top_k
// per chunk); no Pallas kernel of its stands behind it. Per query, the top
// k rows of the table by
//
//   dot   = the bf16 x bf16 -> f32 tensor-core product of the query's and
//           the row's bf16 copies,
//   score = __fsub_rn(__fsub_rn(__fmul_rn(2, dot), qq), sq)
//
// best first, ties to the lowest row id, (-inf, -1) in empty slots: the
// function of scan_lowp.cu's lowp_tile_kernel<Bf16Core> (the general form,
// which serves rows that are not a multiple of 16 bytes and operands off a
// 16-byte boundary). Every product is exact in f32; the sums round in the
// tensor cores' order, so the two forms agree bit for bit where every
// partial sum is exact (integer data) and to f32 rounding of the sums
// elsewhere.
//
// Bound on the H100: 2*B*N*D bf16 tensor-core operations (0.53 ms at B =
// 2048, N = 1,000,064, D = 128) against (B + N)*D*2 bytes. The general
// form runs at 16% of it (3.2 ms): its mma.sync products read both
// operands through ldmatrix, it copies its queries again for every row
// tile, and its score epilogue runs after its products. This form is
// scan_int8.cu's (A-int8's wgmma form) on the bf16 instruction:
//
// * A block holds 128 queries: two consumer warpgroups of 64, each with
//   its own queries against the same row tile, and a producer warpgroup
//   whose first lane keeps a ring of STAGES chunks in flight: 2-D tensor
//   copies (TMA) of 128 rows x 128 bytes (64 bf16) of the [N, row_bytes]
//   table in the 128-byte swizzle, and 1-D ones of the tile's sq, each
//   landing on its stage's mbarrier; rows past N and bytes past the row
//   arrive as zeros. The block's queries arrive once, the same way, and
//   stay resident for the whole split up to QRES_CHUNKS chunks (rows of up
//   to 1024 bytes, D <= 512); wider rows stream their query chunk through
//   the ring beside the row chunk. The producer gives its registers to the
//   consumers (setmaxnreg).
// * Each consumer warpgroup issues wgmma.mma_async m64n128k16
//   .f32.bf16.bf16, both operands K-major from shared memory (a k-step of
//   16 bf16 is 32 bytes, as A-int8's s8 k32 step). Thread (warp w, lane 4g
//   + i) holds queries 16w + g and 16w + g + 8 of its warpgroup against 32
//   rows each, so the queries' key and qq live in registers. A warpgroup
//   scores tile t while the other's MMAs run, and takes its drain vote
//   under its own.
// * The epilogue: every row's exact score (three rounded f32 steps), a
//   running max per query, one compare against the query's key and one
//   warp vote a tile. A warp whose vote passes scores its rows again,
//   one a lane at a time, and admits those strictly above the key. The
//   exact score is as cheap as a filter's bound would be (A-int8's filter
//   pays for its nine-step score; this one has three), so no filter
//   stands before it: tools/bf16_core_study.cu prices the epilogue.
// * Selection: kernel A's heaps, drain vote, splits' shared k-th best
//   and list_merge_kernel (scan_heap.cuh), in the frame both wgmma forms
//   share (hopper_ptx.cuh Frame, Scan, Launch: the producer, the tile
//   loop, the drains, the last sort and the launch).
//
// tools/bf16_core_study.cu times this form beside the general form, its
// MMAs and copies alone, and where a block's cycles go; PERF.md has the
// numbers.
//
// C interface (ctypes, ops/cuda_scan.py): scan_bf16_launch (returns a CUDA
// error code, cudaErrorInvalidValue for a shape or alignment the form
// cannot take, or cudaErrorNotSupported if a tensor map cannot be made),
// scan_bf16_slots, scan_bf16_smem_bytes and scan_bf16_query_tile.

#include "hopper_ptx.cuh"

namespace rht_bf16 {

using namespace rht_hopper;

// consumer warpgroups a block, each with its own 64 queries (the study
// builds others with -DRHT_BF16_CWG=n)
#ifndef RHT_BF16_CWG
#define RHT_BF16_CWG 2
#endif
// ring stages (the study builds others with -DRHT_BF16_STAGES=n)
#ifndef RHT_BF16_STAGES
#define RHT_BF16_STAGES 4
#endif
// The block's geometry (hopper_ptx.cuh Frame): one vector a tile (sq);
// the form's own shared memory is three buffers of the rows' sq (+inf
// past N) per consumer warpgroup (a tile's stage is refilled before its
// epilogue).
using F = Frame<RHT_BF16_CWG, RHT_BF16_STAGES, 1, RHT_BF16_CWG * 3 * 128 * 4>;
constexpr int CWG = F::CWG;
constexpr int TILE_Q = F::TILE_Q;
constexpr int TILE_N = F::TILE_N;
constexpr int STAGES = F::STAGES;
constexpr int THREADS = F::THREADS;
constexpr int ACC = F::ACC;
constexpr int SQV_AT = F::CORE_AT;
constexpr unsigned FULL = 0xffffffffu;
// The selection's knobs (tools/bf16_core_study.cu times other values): a
// drain runs once an append pushed a buffer past DRAIN_AT entries (at most
// BUF_CAP - TILE_N: a tile must fit); every REFRESH tiles an owner looks
// for a better shared k-th best. SCORES = false leaves the MMAs and copies
// alone, a timing the study takes.
struct Tuning {
  static constexpr int DRAIN_AT = 16;
  static constexpr int REFRESH = 64;
  static constexpr bool SCORES = true;
};

// Dynamic shared memory of a block.
__host__ __device__ constexpr int smem_bytes(int row_bytes) {
  return F::smem_bytes(row_bytes);
}

// -- the wgmma instruction -------------------------------------------------

// d (+)= A[64 x 16] . B[128 x 16]^T, bf16 x bf16 -> f32, both K-major (no
// transpose, scales +1); d is overwritten when scale_d is 0.
__device__ __forceinline__ void wgmma_bf16(float (&d)[ACC], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, "
      "0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// -- the score ---------------------------------------------------------------

__device__ __forceinline__ float score(float dot, float qn, float sn) {
  return __fsub_rn(__fsub_rn(__fmul_rn(2.f, dot), qn), sn);
}

// -- the kernel -------------------------------------------------------------

// Block (query tile, split) selects, per query, the top k of its split's
// rows into the (split, query) slab (hopper_ptx.cuh Scan).
template <class Probe, class Tune = Tuning>
__global__ void __launch_bounds__(THREADS, 1)
    bf16_tile_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap sqmap,
                     const float* __restrict__ qq, int B, int N,
                     int row_bytes, int k, int ntiles, int tiles_per_split,
                     int slab_len, int2* __restrict__ slabs,
                     unsigned* __restrict__ kshare) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Scan<F, Tune, Probe> blk(smem_raw, B, N, row_bytes, k, ntiles,
                           tiles_per_split, slab_len, slabs, kshare);
  if (blk.wg == CWG) {
    const CUtensorMap* const vmaps[1] = {&sqmap};
    blk.produce(&qmap, &xmap, vmaps);
  } else {
    blk.consumer();
    const int wg = blk.wg, tw = blk.tw, lane = blk.lane, tig = blk.tig;
    const int t_begin = blk.t_begin;
    const int(&qb)[2] = blk.qb;
    const float(&key)[2] = blk.key;
    float qn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qn[h] = blk.q0 + qb[h] < B ? qq[blk.q0 + qb[h]] : 0.f;
    }
    float* const sqv_s = reinterpret_cast<float*>(blk.smem + SQV_AT);

    // Tile t's rows' sq into buffer (t - t_begin) % 3 of this warpgroup,
    // +inf past N (such a row scores -inf), from ring stage s.
    auto rows = [&](int s, int t) RHT_INLINE {
      const bool live_row = t * TILE_N + tw < N;
      sqv_s[(wg * 3 + (t - t_begin) % 3) * TILE_N + tw] =
          live_row ? blk.vec(s, 0)[tw] : CUDART_INF_F;
    };
    // Score finished tile t and append every row that beats its query's
    // key.
    auto epilogue = [&](const float(&acc)[ACC], int t) RHT_INLINE {
      const int r0 = t * TILE_N;
      const float* const sqv = sqv_s + (wg * 3 + (t - t_begin) % 3) * TILE_N;
      // acc[4j + 2h + e]: query qb[h], row r0 + 8j + 2 tig + e; the max
      // of the exact scores, in four chains a query
      float top[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int x = 0; x < 4; ++x) top[h][x] = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < ACC / 4; ++j) {
        const float2 sv =
            *reinterpret_cast<const float2*>(sqv + 8 * j + 2 * tig);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& m0 = top[h][(2 * j) % 4];
          float& m1 = top[h][(2 * j + 1) % 4];
          m0 = fmaxf(m0, score(acc[4 * j + 2 * h], qn[h], sv.x));
          m1 = fmaxf(m1, score(acc[4 * j + 2 * h + 1], qn[h], sv.y));
        }
      }
      bool pass[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pass[h] = fmaxf(fmaxf(top[h][0], top[h][1]),
                        fmaxf(top[h][2], top[h][3])) > key[h];
      }
      const bool any = __any_sync(FULL, pass[0] || pass[1]);
      blk.probe.mark(P_COMPARE);
      blk.probe.count(C_EPILOGUES, lane == 0);
      if (!any) return;
      blk.probe.count(C_SLOW, lane == 0);
      // The rows above the key, a few a warp. Bit 2j + e of cm[h]: acc[4j
      // + 2h + e] is one. Each lane takes one of each query's at a time
      // (the accumulators are only read: a write would make the next wgmma
      // wait on it), scores it again and appends it.
      unsigned cm[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < ACC / 4; ++j) {
        const float2 sv =
            *reinterpret_cast<const float2*>(sqv + 8 * j + 2 * tig);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          cm[h] |= (unsigned)(pass[h] &&
                              score(acc[4 * j + 2 * h], qn[h], sv.x) > key[h])
                   << (2 * j);
          cm[h] |= (unsigned)(pass[h] && score(acc[4 * j + 2 * h + 1], qn[h],
                                               sv.y) > key[h])
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
          rl[h] = 8 * (i >> 1) + 2 * tig + (i & 1);
          sc[h] = score(acc_pick(acc, h, i), qn[h], sqv[rl[h]]);
          ok[h] = has && r0 + rl[h] < N && sc[h] > key[h];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (ok[h]) blk.append(h, sc[h], r0 + rl[h]);
        }
      }
      blk.probe.mark(P_ADMIT);
    };
    float acc[ACC];
    blk.tiles(
        acc, rows,
        [](float(&d)[ACC], uint64_t a, uint64_t b, int scale_d) RHT_INLINE {
          wgmma_bf16(d, a, b, scale_d);
        },
        epilogue, []() RHT_INLINE {});
    blk.finish();
  }
}

// -- host side --------------------------------------------------------------

// Whether this form takes a shape: rows a multiple of 16 bytes, the
// queries, the table and sq on 16-byte boundaries (a tensor map's terms).
inline bool takes(const void* q, const void* x, const float* sq,
                  int row_bytes) {
  return map_takes(row_bytes, {q, x, sq});
}

template <class Probe, class Tune = Tuning>
int launch_form(const unsigned char* q, const unsigned char* x,
                const float* qq, const float* sq, int B, int N, int row_bytes,
                int k, int splits, int2* slabs, unsigned* kshare,
                float* out_s, int* out_i, cudaStream_t stream) {
  if (B <= 0 || k <= 0) return 0;
  const Launch<F> L(B, N, row_bytes, k, splits);
  if (!L.takes(N, splits) || !takes(q, x, sq, row_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap qmap, xmap, sqmap;
  if (!byte_map(q, B, row_bytes, TILE_Q, &qmap) ||
      !byte_map(x, N, row_bytes, TILE_N, &xmap) ||
      !float_map(sq, N, TILE_N, &sqmap)) {
    return (int)cudaErrorNotSupported;
  }
  auto* const kernel = bf16_tile_kernel<Probe, Tune>;
  const int err = L.prepare(kernel, B, kshare, stream);
  if (err != 0) return err;
  kernel<<<L.grid, THREADS, L.smem, stream>>>(
      qmap, xmap, sqmap, qq, B, N, row_bytes, k, L.ntiles, L.tiles_per_split,
      L.slab_len, slabs, kshare);
  return L.finish(slabs, B, k, splits, out_s, out_i, stream);
}

template <class Probe>
int blocks_per_sm(int row_bytes) {
  return resident_blocks<F>(bf16_tile_kernel<Probe>, row_bytes);
}

}  // namespace rht_bf16

// Resident blocks on the current card at 256-byte rows (D = 128: the
// planner's slots), or a negative value on failure.
extern "C" int scan_bf16_slots() {
  const int sms = rht_scan::card_sms();
  const int n = rht_bf16::blocks_per_sm<rht_bf16::NoProbe>(256);
  if (sms <= 0 || n <= 0) return -1;
  return n * sms;
}

// A block's dynamic shared memory, in bytes, at rows of row_bytes.
extern "C" int scan_bf16_smem_bytes(int row_bytes) {
  return rht_bf16::smem_bytes(row_bytes);
}

// Queries a block (the planner's query tile).
extern "C" int scan_bf16_query_tile() { return rht_bf16::TILE_Q; }

// q [B][row_bytes] and x [N][row_bytes] bf16 (row_bytes a multiple of 16),
// qq [B] and sq [N] f32; q, x and sq 16-byte aligned.
// slabs: [splits][B][scan_topk_slab_len(k)] int2 and kshare [B] uint32
// scratch.
extern "C" int scan_bf16_launch(const void* q, const void* x, const float* qq,
                                const float* sq, int B, int N, int row_bytes,
                                int k, int splits, int2* slabs,
                                unsigned* kshare, float* out_s, int* out_i,
                                cudaStream_t stream) {
  return rht_bf16::launch_form<rht_bf16::NoProbe>(
      static_cast<const unsigned char*>(q),
      static_cast<const unsigned char*>(x), qq, sq, B, N, row_bytes, k,
      splits, slabs, kshare, out_s, out_i, stream);
}
