// Design study of kernel C (redis_hnsw_tpu_torch/csrc/block_score.cu), the
// graph beam's fused block gather-score, beside the first port's kernel
// (carried here unchanged as the baseline: synchronous 16-byte loads
// staged as f32 through shared memory, two __syncthreads a 32-dim
// chunk). The shipped kernel -- a ring of bulk asynchronous copies a
// warp; the block form's
// rows read with each lane's chain skewed by (lane & 7) 16-byte steps;
// the row form's rows an odd number of 16-byte units apart -- is timed at
// its planned (warps, ring) and at others, and beside these forms:
//
//   direct        the shipped general form (one thread an output, rows
//                 read straight from the table)
//   tensor2d      the block form through 2D tensor copies (a tensor map,
//                 32-row x 128-byte boxes) into the 128-byte swizzle, rows
//                 read unskewed and un-swizzled, q through L1
//   v1 *          the first design on one per-warp ring: q[b] and the two
//                 sqnorms staged with the rows (4-byte cp.async, 64
//                 arrivals a stage); "v1 skew" reads skewed (branch-free),
//     skew/branch   skewed with a branch around the steps outside the row,
//     bulk/plain    unskewed (8 lanes of a quarter warp on one bank group),
//     cpasync/pad   16-byte cp.async by the 32 lanes into rows padded by 16
//                   bytes, read unskewed,
//     cpasync/skew  the same copies into unpadded rows, read skewed,
//     rows/skew     one bulk copy a row (skewed), rows/pad into padded rows,
//     fence         "v1 skew" with a fence.proxy.async before each refill;
//   copies only / scoring only / probe   the v1 skew form with its scoring
//                 or its copies taken out (timing only), and the cycles a
//                 warp spends an item waiting, scoring and refilling.
//
// Shapes: B = 2048 lanes x E = 16 candidates of F = 32 x D = 128 blocks
// over a 1,000,064-block table (f32, f16, bf16), B = 16, and the row form
// (F = 1) at B = 2048 with J = 512 and J = 16 rows over 1,000,064 rows,
// also with every other id row 0 (the beam clamps its masked slots to row
// 0, so the off tier's and the descent's row lists hold it many times).
// Data are Gaussian (a hash of the index, Box-Muller). Every form's
// output must equal the first port's kernel's bit for bit: all compute
// each output as one in-order fma chain, so equal bits on Gaussian data
// show the redesign kept it.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -Xptxas -v -o /tmp/block_score_study tools/block_score_study.cu
//   /tmp/block_score_study
//
// One line per shape and form: warps, ring, grid, ms per launch (best of
// 3 means of 20 launches, CUDA events), share of the byte bound, and
// whether the output equals the first port's bit for bit. Exits 1 on any
// mismatch.

#include "../redis_hnsw_tpu_torch/csrc/block_score.cu"

#include <cuda.h>

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <vector>

#define CK(x)                                                          \
  do {                                                                 \
    cudaError_t e_ = (x);                                              \
    if (e_ != cudaSuccess) {                                           \
      printf("CUDA error %s at line %d\n", cudaGetErrorString(e_),     \
             __LINE__);                                                \
      exit(1);                                                         \
    }                                                                  \
  } while (0)

// The first port's kernel, unchanged but for its namespace.

namespace first {

constexpr int BS_TILE_D = 32;
constexpr int BS_LD = BS_TILE_D + 4;   // staged row stride, floats
constexpr int BS_MAX_ROWS = 256;       // threads (= staged rows) per block

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 loaded bytes of T (4 floats, or 8 halves), widened to f32 and
// stored at dst (16-byte aligned shared memory). The words are unpacked
// by bit operations (the lower half of a word is the earlier element),
// so the loaded registers never need an address.
__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

template <typename T>
__device__ __forceinline__ void widen16(const uint4& raw, float* dst);

template <>
__device__ __forceinline__ void widen16<float>(const uint4& raw, float* dst) {
  store4(dst, __uint_as_float(raw.x), __uint_as_float(raw.y),
         __uint_as_float(raw.z), __uint_as_float(raw.w));
}

__device__ __forceinline__ float half_lo(unsigned w) {
  return __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
}
__device__ __forceinline__ float half_hi(unsigned w) {
  return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}

template <>
__device__ __forceinline__ void widen16<__half>(const uint4& raw,
                                                float* dst) {
  store4(dst, half_lo(raw.x), half_hi(raw.x), half_lo(raw.y),
         half_hi(raw.y));
  store4(dst + 4, half_lo(raw.z), half_hi(raw.z), half_lo(raw.w),
         half_hi(raw.w));
}

// bf16 -> f32 is exact: the bf16 bits are the f32's upper half
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <>
__device__ __forceinline__ void widen16<__nv_bfloat16>(const uint4& raw,
                                                       float* dst) {
  store4(dst, bf16_lo(raw.x), bf16_hi(raw.x), bf16_lo(raw.y),
         bf16_hi(raw.y));
  store4(dst + 4, bf16_lo(raw.z), bf16_hi(raw.z), bf16_lo(raw.w),
         bf16_hi(raw.w));
}

// First element of row r (candidate e0 + r / F, neighbour r % F) of
// lane b's group in nbrvec
__device__ __forceinline__ size_t row_base(const int* __restrict__ cand,
                                           int b, int E, int e0, int F,
                                           int D, int r) {
  const int c = cand[(size_t)b * E + e0 + r / F];
  return ((size_t)c * F + r % F) * (size_t)D;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(BS_MAX_ROWS)
    block_score_kernel(const float* __restrict__ q,
                       const float* __restrict__ qn,
                       const T* __restrict__ nbrvec,
                       const float* __restrict__ nbrsqn,
                       const int* __restrict__ cand, int E, int F, int D,
                       int G, float* __restrict__ out) {
  __shared__ __align__(16) float xs[BS_MAX_ROWS][BS_LD];
  __shared__ __align__(16) float qs[BS_TILE_D];
  const int b = blockIdx.x;
  const int e0 = blockIdx.y * G;
  const int g_here = min(G, E - e0);
  const int rows = g_here * F;
  const int t = threadIdx.x;  // this thread's output row: (e0 + t/F, t%F)

  float dot = 0.f;
  for (int d0 = 0; d0 < D; d0 += BS_TILE_D) {
    const int w = min(BS_TILE_D, D - d0);
    __syncthreads();  // the previous chunk's readers are done
    if (VEC) {
      constexpr int PER = 16 / sizeof(T);  // elements per 16-byte load
      const int vw = w / PER;              // loads per row (w % PER == 0)
      for (int i = t; i < rows * vw; i += blockDim.x) {
        const int r = i / vw;
        const int v = i % vw;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            nbrvec + row_base(cand, b, E, e0, F, D, r) + d0 + v * PER);
        widen16<T>(raw, &xs[r][v * PER]);
      }
    } else {
      for (int i = t; i < rows * w; i += blockDim.x) {
        const int r = i / w;
        const int d = i % w;
        xs[r][d] = widen(nbrvec[row_base(cand, b, E, e0, F, D, r) + d0 + d]);
      }
    }
    for (int d = t; d < w; d += blockDim.x) qs[d] = q[(size_t)b * D + d0 + d];
    __syncthreads();
    if (t < rows) {
      int d = 0;
      for (; d + 4 <= w; d += 4) {
        const float4 x4 = *reinterpret_cast<const float4*>(&xs[t][d]);
        const float4 q4 = *reinterpret_cast<const float4*>(&qs[d]);
        dot = __fmaf_rn(q4.x, x4.x, dot);
        dot = __fmaf_rn(q4.y, x4.y, dot);
        dot = __fmaf_rn(q4.z, x4.z, dot);
        dot = __fmaf_rn(q4.w, x4.w, dot);
      }
      for (; d < w; ++d) dot = __fmaf_rn(qs[d], xs[t][d], dot);
    }
  }
  if (t < rows) {
    const int c = cand[(size_t)b * E + e0 + t / F];
    const float fn = nbrsqn[(size_t)c * F + t % F];
    out[(size_t)b * E * F + (size_t)e0 * F + t] =
        __fsub_rn(__fsub_rn(__fmul_rn(2.f, dot), qn[b]), fn);
  }
}

template <typename T>
int launch_typed(const float* q, const float* qn, const void* nbrvec,
                 const float* nbrsqn, const int* cand, int B, int E, int F,
                 int D, int vec16, float* out, cudaStream_t stream) {
  const int G = BS_MAX_ROWS / F < E ? BS_MAX_ROWS / F : E;
  const dim3 grid(B, (E + G - 1) / G);
  const int threads = ((G * F + 31) / 32) * 32;
  const T* nv = static_cast<const T*>(nbrvec);
  if (vec16) {
    block_score_kernel<T, true><<<grid, threads, 0, stream>>>(
        q, qn, nv, nbrsqn, cand, E, F, D, G, out);
  } else {
    block_score_kernel<T, false><<<grid, threads, 0, stream>>>(
        q, qn, nv, nbrsqn, cand, E, F, D, G, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace first

namespace study {

using namespace rht;

enum { BULK = 0, CPASYNC = 1 };
enum { SKEW = 0, PAD = 1, PLAIN = 2, SKEW_BRANCH = 3 };

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void cp4_g2s(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// The skewed chain of the first design: lane l runs (l & 7) 16-byte steps
// late over a row of unswizzled 16-byte columns, so that the 8 lanes of a
// quarter warp read 8 different columns; a step outside 0 .. nv-1 reads a
// wrapped column and its result is discarded by a select.
template <typename T>
__device__ __forceinline__ float row_dot_skew(const float* qrow,
                                              const unsigned char* x, int nv,
                                              int skew) {
  constexpr int PER = 16 / sizeof(T);
  float dot = 0.f;
  int v = -skew;
  int col = ((v % nv) + nv) % nv;
#pragma unroll 8
  for (int i = 0; i < nv + 7; ++i) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + col * 16);
    const float next = fma16<T>(raw, qrow + col * PER, dot);
    dot = (unsigned)v < (unsigned)nv ? next : dot;
    ++v;
    col = col + 1 == nv ? 0 : col + 1;
  }
  return dot;
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}


template <typename T>
__device__ __forceinline__ float row_dot_plain(const float* qrow,
                                               const unsigned char* x,
                                               int nv) {
  constexpr int PER = 16 / sizeof(T);
  float dot = 0.f;
#pragma unroll 4
  for (int v = 0; v < nv; ++v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + v * 16);
    dot = fma16<T>(raw, qrow + v * PER, dot);
  }
  return dot;
}

// The skewed chain as calls 1-4 of the study ran it: a branch around
// each step outside 0 .. nv-1, which kept later steps' loads from
// issuing ahead of the chain.
template <typename T>
__device__ __forceinline__ float row_dot_branch(const float* qrow,
                                                const unsigned char* x,
                                                int nv, int skew) {
  constexpr int PER = 16 / sizeof(T);
  float dot = 0.f;
#pragma unroll 4
  for (int i = 0; i < nv + 7; ++i) {
    const int v = i - skew;
    if ((unsigned)v < (unsigned)nv) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + v * 16);
      dot = fma16<T>(raw, qrow + v * PER, dot);
    }
  }
  return dot;
}

__host__ __device__ constexpr int pitch_of(int layout, int row_bytes) {
  return layout == PAD ? row_bytes + 16 : row_bytes;
}


// The shipped kernel with the copy engine and the layout as knobs, and
// FENCE: a fence.proxy.async before each refill (the shipped kernel has
// none: a stage's reads are done before its refill is issued).
__host__ __device__ constexpr int vscalars(int form, int layout, int D,
                                           int elem) {
  return BS_LANES * pitch_of(layout, D * elem) + (form == BS_BLOCK ? D * 4 : 0);
}

__host__ __device__ constexpr int vstage(int form, int layout, int D,
                                         int elem) {
  return (vscalars(form, layout, D, elem) + 2 * BS_LANES * 4 + 127) / 128 *
         128;
}

// PART (timing only): 1 = the copies alone (each lane reads one word of
// its row), 2 = the scoring alone (no copies: stale stages, every lane
// still arrives twice).
enum { FULL = 0, COPIES = 1, SCORING = 2 };


// PROBE: each warp's cycles (clock64) in its waits, its chains (with
// the epilogue), and its refills, summed into g_probe with the items.
__device__ unsigned long long g_probe[4];

template <typename T, int FORM, int PROD, int LAYOUT, bool FENCE,
          int PART = FULL, bool PROBE = false>
__global__ void __launch_bounds__(BS_MAX_WARPS * 32)
    variant(const float* __restrict__ q, const float* __restrict__ qn,
            const T* __restrict__ nbrvec, const float* __restrict__ nbrsqn,
            const int* __restrict__ cand, int E, int F, int D,
            long long items, long long rows, long long per_warp, int ring,
            float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long first =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * per_warp;
  const long long last = min(items, first + per_warp);
  if (first >= last) return;
  const int row_bytes = D * (int)sizeof(T);
  const int pitch = pitch_of(LAYOUT, row_bytes);
  const int stage = vstage(FORM, LAYOUT, D, sizeof(T));
  const int scalars = vscalars(FORM, LAYOUT, D, sizeof(T));
  const int chunks = (F + BS_LANES - 1) / BS_LANES;
  const int nv = row_bytes / 16;
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem) + warp * BS_MAX_RING;
  unsigned char* const ring0 = smem + BS_HDR + (size_t)warp * ring * stage;
  if (lane < ring) mbar_init(bar + lane, 2 * BS_LANES);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncwarp();

  struct Lane {
    long long slot, b;
    int f;
    bool live;
  };
  auto lane_of = [&](long long it, int ln) -> Lane {
    if constexpr (FORM == BS_ROWS) {
      const long long slot = it * BS_LANES + ln;
      const long long p = slot < rows ? slot / F : 0;
      return Lane{slot, p / E, (int)(slot - p * F), slot < rows};
    } else {
      const long long p = it / chunks;
      const int f = (int)(it - p * chunks) * BS_LANES + ln;
      return Lane{p * F + f, p / E, f, f < F};
    }
  };
  auto id_of = [&](long long it) -> int {
    if constexpr (FORM == BS_ROWS) {
      const long long r = it * BS_LANES + lane;
      return r < rows ? cand[r / F] : 0;
    } else {
      return cand[it / chunks];
    }
  };
  auto issue = [&](long long it, int s, int id) {
    unsigned char* st = ring0 + (size_t)s * stage;
    float* sc = reinterpret_cast<float*>(st + scalars);
    uint64_t* bs = bar + s;
    const Lane l = lane_of(it, lane);
    if constexpr (PART == SCORING) {
      mbar_arrive(bs);
      mbar_arrive(bs);
      return;
    }
    if constexpr (PROD == BULK) {
      if constexpr (FORM == BS_ROWS) {
        if (l.live) {
          mbar_arrive_tx(bs, row_bytes);
          bulk_g2s(st + lane * pitch, nbrvec + ((size_t)id * F + l.f) * D,
                   row_bytes, bs);
        } else {
          mbar_arrive(bs);
        }
      } else {
        if (lane == 0) {
          const int nr = min(BS_LANES, F - l.f);
          mbar_arrive_tx(bs, nr * row_bytes + D * 4);
          bulk_g2s(st, nbrvec + ((size_t)id * F + l.f) * D, nr * row_bytes,
                   bs);
          bulk_g2s(st + BS_LANES * pitch, q + (size_t)l.b * D, D * 4, bs);
        } else {
          mbar_arrive(bs);
        }
      }
    } else {
      for (int j = 0; j < BS_LANES; ++j) {
        const Lane lj = lane_of(it, j);
        if (!lj.live) break;
        const int jid = __shfl_sync(0xffffffffu, id, j);
        const unsigned char* s8 = reinterpret_cast<const unsigned char*>(
            nbrvec + ((size_t)jid * F + lj.f) * D);
        for (int v = lane; v < nv; v += 32)
          cp16(st + j * pitch + v * 16, s8 + v * 16);
      }
      if constexpr (FORM == BS_BLOCK) {
        const unsigned char* qs =
            reinterpret_cast<const unsigned char*>(q + (size_t)l.b * D);
        for (int v = lane; v < D / 4; v += 32)
          cp16(st + BS_LANES * pitch + v * 16, qs + v * 16);
      }
      mbar_arrive(bs);
    }
    if (l.live) {
      cp4_g2s(sc + lane, nbrsqn + (size_t)id * F + l.f);
      cp4_g2s(sc + BS_LANES + lane, qn + l.b);
    }
    cp_arrive(bs);
  };

  for (int s = 0; s < ring && first + s < last; ++s)
    issue(first + s, s, id_of(first + s));
  int s = 0;
  uint32_t parity = 0;
  unsigned long long t_wait = 0, t_chain = 0, t_issue = 0;
  for (long long it = first; it < last; ++it) {
    const long long c0 = PROBE ? clock64() : 0;
    const Lane l = lane_of(it, lane);
    const bool refill = it + ring < last;
    const int next_id = refill ? id_of(it + ring) : 0;
    const unsigned char* st = ring0 + (size_t)s * stage;
    const float* sc = reinterpret_cast<const float*>(st + scalars);
    const float* qrow =
        FORM == BS_ROWS
            ? q + (size_t)l.b * D
            : reinterpret_cast<const float*>(st + BS_LANES * pitch);
    mbar_wait(bar + s, parity);
    const long long c1 = PROBE ? clock64() : 0;
    if (l.live) {
      const float dot =
          PART == COPIES
              ? *reinterpret_cast<const float*>(st + lane * pitch)
          : LAYOUT == SKEW
              ? row_dot_skew<T>(qrow, st + lane * pitch, nv, lane & 7)
          : LAYOUT == SKEW_BRANCH
              ? row_dot_branch<T>(qrow, st + lane * pitch, nv, lane & 7)
              : row_dot_plain<T>(qrow, st + lane * pitch, nv);
      out[l.slot] = epilogue(dot, sc[BS_LANES + lane], sc[lane]);
    }
    __syncwarp();
    const long long c2 = PROBE ? clock64() : 0;
    if (refill) {
      if (FENCE) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(it + ring, s, next_id);
    }
    if (PROBE) {
      __syncwarp();
      const long long c3 = clock64();
      t_wait += c1 - c0;
      t_chain += c2 - c1;
      t_issue += c3 - c2;
    }
    if (++s == ring) {
      s = 0;
      parity ^= 1;
    }
  }
  if (PROBE && lane == 0) {
    atomicAdd(&g_probe[0], t_wait);
    atomicAdd(&g_probe[1], t_chain);
    atomicAdd(&g_probe[2], t_issue);
    atomicAdd(&g_probe[3], (unsigned long long)(last - first));
  }
}

// The box of `tmap` at (column x, row y) to shared dst (1024-byte aligned),
// completing on bar's transaction count.
__device__ __forceinline__ void tile_g2s(void* dst, const CUtensorMap* tmap,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A tensor map of a table [rows, D] (32-row, 128-byte
// boxes, 128-byte swizzle), encoded once per (table, shape, type) and
// kept in a small cache: the beam launches kernel C many times a batch on
// one table. Returns false if cuTensorMapEncodeTiled refuses it.
bool table_map(const void* table, long long rows, int D, int dtype,
               CUtensorMap* out) {
  struct Entry {
    const void* table;
    long long rows;
    int D, dtype;
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry cache[8];
  static int used = 0, next = 0;
  static EncodeTiled encode = nullptr;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.table == table && e.rows == rows && e.D == D && e.dtype == dtype) {
      *out = e.map;
      return true;
    }
  }
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult got;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &got) != cudaSuccess ||
        got != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return false;
    }
  }
  const int elem = dtype == 0 ? 4 : 2;
  const CUtensorMapDataType type =
      dtype == 0   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem), BS_LANES};
  const cuuint32_t unit[2] = {1, 1};
  CUtensorMap map;
  if (encode(&map, type, 2, const_cast<void*>(table), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  Entry& e = cache[next];
  e = Entry{table, rows, D, dtype, map};
  next = (next + 1) % 8;
  used = used < 8 ? used + 1 : 8;
  *out = map;
  return true;
}


// The block form through 2D tensor copies: one tiled copy per 128-byte
// column of the item's 32 rows, landing in the 128-byte swizzle (16-byte
// chunk c of row r at chunk c ^ (r % 8)); rows read unskewed (un-swizzled
// on read) and q read through L1, a broadcast. Otherwise the shipped
// block form: one arrival an item, the scalar pipeline in registers.
constexpr int COL = 128;

template <typename T>
__global__ void __launch_bounds__(BS_MAX_WARPS * 32)
    tensor_variant(const __grid_constant__ CUtensorMap tmap,
                   const float* __restrict__ q, const float* __restrict__ qn,
                   const float* __restrict__ nbrsqn,
                   const int* __restrict__ cand, int E, int F, int D,
                   long long items, long long per_warp, int ring,
                   float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int PER = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long first =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * per_warp;
  const long long last = min(items, first + per_warp);
  if (first >= last) return;
  const int row_bytes = D * (int)sizeof(T);
  const int cols = row_bytes / COL;
  const int stage = BS_LANES * row_bytes;
  const int chunks = (F + BS_LANES - 1) / BS_LANES;
  const uint32_t base = smem_u32(smem);
  unsigned char* const ring0 =
      smem + ((base + BS_HDR + 1023) & ~1023u) - base +
      (size_t)warp * ring * stage;
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem) + warp * BS_MAX_RING;
  const CUtensorMap* const map = &tmap;
  if (lane < ring) mbar_init(bar + lane, 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncwarp();
  auto issue = [&](long long it, int s) {
    if (lane != 0) return;
    const long long p = it / chunks;
    const int f0 = (int)(it - p * chunks) * BS_LANES;
    const int id = cand[p];
    unsigned char* st = ring0 + (size_t)s * stage;
    mbar_arrive_tx(bar + s, cols * BS_LANES * COL);
    for (int k = 0; k < cols; ++k)
      tile_g2s(st + k * (BS_LANES * COL), map, k * (COL / (int)sizeof(T)),
               id * F + f0, bar + s);
  };
  for (int s = 0; s < ring && first + s < last; ++s) issue(first + s, s);
  int s = 0;
  uint32_t parity = 0;
  for (long long it = first; it < last; ++it) {
    const long long p = it / chunks;
    const int f = (int)(it - p * chunks) * BS_LANES + lane;
    const bool live = f < F;
    const float fn = live ? nbrsqn[(size_t)cand[p] * F + f] : 0.f;
    const float qnb = qn[p / E];
    const float* qrow = q + (size_t)(p / E) * D;
    const unsigned char* st = ring0 + (size_t)s * stage;
    mbar_wait(bar + s, parity);
    float dot = 0.f;
    for (int k = 0; k < cols; ++k) {
      const unsigned char* tile = st + k * (BS_LANES * COL) + lane * COL;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(tile + ((c ^ (lane & 7)) << 4));
        dot = fma16<T>(raw, qrow + (k * 8 + c) * PER, dot);
      }
    }
    if (live) out[p * F + f] = epilogue(dot, qnb, fn);
    __syncwarp();
    if (it + ring < last) issue(it + ring, s);
    if (++s == ring) {
      s = 0;
      parity ^= 1;
    }
  }
}

template <typename T>
void run_tensor(const float* q, const float* qn, const void* table,
                const float* sqn, const int* cand, int N, int B, int E,
                int F, int D, int dtype, int warps, int ring, int grid,
                long long per_warp, float* out) {
  CUtensorMap map;
  if (!table_map(table, (long long)N * F, D, dtype, &map)) {
    printf("tensor map refused\n");
    exit(1);
  }
  const int stage = BS_LANES * D * (int)sizeof(T);
  const size_t smem = BS_HDR + 1024 + (size_t)warps * ring * stage;
  auto k = tensor_variant<T>;
  CK(cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                          BS_MAX_SMEM));
  const long long items = (long long)B * E * ((F + 31) / 32);
  k<<<grid, warps * 32, smem>>>(map, q, qn, sqn, cand, E, F, D, items,
                                per_warp, ring, out);
  CK(cudaGetLastError());
}

// -- data ------------------------------------------------------------------

__device__ __forceinline__ uint64_t mix(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

__device__ __forceinline__ float gauss(uint64_t seed, size_t i) {
  const uint64_t h = mix(seed * 0x100000001b3ull + i);
  const float u1 = ((h >> 40) + 1) * (1.f / 16777217.f);
  const float u2 = ((h & 0xffffff) + 0.5f) * (1.f / 16777216.f);
  return sqrtf(-2.f * logf(u1)) * cospif(2.f * u2);
}

__global__ void fill_gauss(float* x, size_t n, uint64_t seed) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    x[i] = gauss(seed, i);
}

__global__ void zero_odd(const int* x, int* y, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    y[i] = i % 2 ? 0 : x[i];
}

__global__ void fill_ids(int* x, size_t n, int range, uint64_t seed) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    x[i] = (int)(mix(seed * 0x100000001b3ull + i) % (uint64_t)range);
}

__device__ __forceinline__ void store_narrow(__half* y, float v) {
  *y = __float2half_rn(v);
}
__device__ __forceinline__ void store_narrow(__nv_bfloat16* y, float v) {
  *y = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void narrow(const float* x, T* y, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    store_narrow(y + i, x[i]);
}

// -- plans and timing --------------------------------------------------------

struct Plan {
  int form, warps, ring, grid;
  long long per_warp;
};

// ops/cuda_gather.py plan(), with (warps, ring) optionally forced.
Plan plan(int sms, int B, int E, int F, int D, int elem, int form,
          int stage, int warps = 0, int ring = 0) {
  const int room = 200 * 1024 - BS_HDR;
  if (warps == 0) warps = std::max(1, std::min(BS_MAX_WARPS, room / stage));
  if (ring == 0)
    ring = std::max(1, std::min(BS_MAX_RING, room / (warps * stage)));
  const long long rows = (long long)B * E * F;
  const long long items = form == BS_ROWS ? (rows + 31) / 32
                                          : (long long)B * E * ((F + 31) / 32);
  const long long per_warp =
      (items + (long long)sms * warps - 1) / ((long long)sms * warps);
  const long long busy = (items + per_warp - 1) / per_warp;
  warps = (int)std::min<long long>(warps, (busy + sms - 1) / sms);
  return Plan{form, warps, ring, (int)((busy + warps - 1) / warps), per_warp};
}

struct Case {
  const char* label;
  int B, E, F, D, dtype;  // dtype 0 f32, 1 f16, 2 bf16
  bool hot;               // every other id is row 0, as masked slots are
};

float time_ms(const std::function<void()>& fn) {
  fn();
  CK(cudaDeviceSynchronize());
  cudaEvent_t e0, e1;
  CK(cudaEventCreate(&e0));
  CK(cudaEventCreate(&e1));
  float best = 1e30f;
  for (int rep = 0; rep < 3; ++rep) {
    CK(cudaEventRecord(e0));
    for (int i = 0; i < 20; ++i) fn();
    CK(cudaEventRecord(e1));
    CK(cudaEventSynchronize(e1));
    float ms;
    CK(cudaEventElapsedTime(&ms, e0, e1));
    best = std::min(best, ms / 20);
  }
  CK(cudaEventDestroy(e0));
  CK(cudaEventDestroy(e1));
  return best;
}

}  // namespace study

using namespace study;

namespace {

struct Ops {
  const float *q, *qn, *sqn;
  const int* cand;
  float *ref, *got;
  size_t out_n;
  int sms, n_blocks;
  bool all_equal = true;
};

template <typename T, int FORM, int PROD, int LAYOUT, bool FENCE = false,
          int PART = FULL, bool PROBE = false>
void run_variant(const Ops& o, const void* table, const Case& c,
                 const Plan& pl) {
  const int stage = vstage(FORM, LAYOUT, c.D, sizeof(T));
  const size_t smem = BS_HDR + (size_t)pl.warps * pl.ring * stage;
  auto k = variant<T, FORM, PROD, LAYOUT, FENCE, PART, PROBE>;
  CK(cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                          BS_MAX_SMEM));
  const long long rows = (long long)c.B * c.E * c.F;
  const long long items = FORM == BS_ROWS
                              ? (rows + 31) / 32
                              : (long long)c.B * c.E * ((c.F + 31) / 32);
  k<<<pl.grid, pl.warps * 32, smem>>>(
      o.q, o.qn, static_cast<const T*>(table), o.sqn, o.cand, c.E, c.F, c.D,
      items, rows, pl.per_warp, pl.ring, o.got);
  CK(cudaGetLastError());
}

void report(Ops& o, const Case& c, const char* name, const Plan* pl,
            float ms, double bound, bool timing_only = false) {
  const size_t n = (size_t)c.B * c.E * c.F;
  std::vector<float> a(n), b(n);
  CK(cudaMemcpy(a.data(), o.ref, n * 4, cudaMemcpyDeviceToHost));
  CK(cudaMemcpy(b.data(), o.got, n * 4, cudaMemcpyDeviceToHost));
  const bool eq = std::memcmp(a.data(), b.data(), n * 4) == 0;
  if (timing_only) {
    printf("%-18s %-14s warps %d ring %2d grid %4d per_warp %5lld  %.4f ms"
           "  %5.1f%% of bound  (timing only)\n",
           c.label, name, pl->warps, pl->ring, pl->grid, pl->per_warp, ms,
           100.0 * bound / ms);
    CK(cudaMemset(o.got, 0xff, o.out_n * 4));
    return;
  }
  o.all_equal &= eq;
  if (pl)
    printf("%-18s %-14s warps %d ring %2d grid %4d per_warp %5lld  %.4f ms"
           "  %5.1f%% of bound  %s\n",
           c.label, name, pl->warps, pl->ring, pl->grid, pl->per_warp, ms,
           100.0 * bound / ms, eq ? "== first bitwise" : "DIFFERS from first");
  else
    printf("%-18s %-14s %57s%.4f ms  %5.1f%% of bound  %s\n", c.label, name,
           "", ms, 100.0 * bound / ms, eq ? "== first bitwise" : "DIFFERS");
  CK(cudaMemset(o.got, 0xff, o.out_n * 4));
}

template <typename T>
void run_case(Ops& o, const void* table, const Case& c) {
  const int elem = sizeof(T);
  const double bytes = (double)c.B * c.E * c.F * c.D * elem +
                       (double)c.B * c.E * c.F * 8 + c.B * c.D * 4.0 +
                       c.B * 4.0 + (double)c.B * c.E * 4;
  const double bound = bytes / 3.35e12 * 1e3;
  printf("%-18s bound %.4f ms (bytes, %.0f MB)\n", c.label, bound,
         bytes / 1e6);
  const T* x = static_cast<const T*>(table);
  auto first_run = [&] {
    CK((cudaError_t)first::launch_typed<T>(o.q, o.qn, x, o.sqn, o.cand, c.B,
                                         c.E, c.F, c.D, 1, o.ref, 0));
  };
  const float first_ms = time_ms(first_run);
  CK(cudaMemcpy(o.got, o.ref, (size_t)c.B * c.E * c.F * 4,
                cudaMemcpyDeviceToDevice));
  report(o, c, "first port", nullptr, first_ms, bound);

  const int form = c.F >= 16 ? BS_BLOCK : BS_ROWS;
  const int stage = bs_stage_bytes(form, c.D, elem);
  auto shipped = [&](const Plan& pl) {
    return time_ms([&] {
      CK((cudaError_t)rht::launch_typed<T>(
          o.q, o.qn, x, o.sqn, o.cand, c.B, c.E, c.F, c.D, pl.form, pl.warps,
          pl.ring, pl.grid, pl.per_warp, o.got, 0));
    });
  };
  const Plan planned = plan(o.sms, c.B, c.E, c.F, c.D, elem, form, stage);
  report(o, c, "shipped", &planned, shipped(planned), bound);
  const int sweep[][2] = {{2, 2},  {3, 2},  {4, 2},  {4, 4},  {6, 2},
                          {8, 1},  {8, 2},  {6, 3},  {10, 1}, {12, 1},
                          {10, 2}, {12, 2}, {16, 1}, {8, 3},  {5, 4}};
  for (const auto& wr : sweep) {
    if (bs_smem_bytes(form, c.D, elem, wr[0], wr[1]) > BS_MAX_SMEM) continue;
    const Plan pl = plan(o.sms, c.B, c.E, c.F, c.D, elem, form, stage, wr[0],
                         wr[1]);
    report(o, c, "shipped", &pl, shipped(pl), bound);
  }
  {
    const long long rows = (long long)c.B * c.E * c.F;
    Plan d{BS_DIRECT, 0, 0,
           (int)std::min<long long>((rows + 255) / 256, o.sms * 8), 0};
    report(o, c, "direct", &d, shipped(d), bound);
  }

  auto var = [&](const char* name, int vform, int layout, auto launcher) {
    const int vst = vstage(vform, layout, c.D, elem);
    const Plan pl = plan(o.sms, c.B, c.E, c.F, c.D, elem, vform, vst);
    if (BS_HDR + (size_t)pl.warps * pl.ring * vst > (size_t)BS_MAX_SMEM)
      return;
    report(o, c, name, &pl, time_ms([&] { launcher(pl); }), bound);
  };
  // which side holds the pipeline: the copies alone, the scoring alone,
  // at 4 and 8 warps
  for (const int w : {4, 8}) {
    const int vst = vstage(form, SKEW, c.D, elem);
    const Plan pl = plan(o.sms, c.B, c.E, c.F, c.D, elem, form, vst, w, 2);
    if (BS_HDR + (size_t)pl.warps * pl.ring * vst > (size_t)BS_MAX_SMEM)
      continue;
    auto go = [&](auto launch, const char* name, bool only) {
      report(o, c, name, &pl, time_ms(launch), bound, only);
    };
    if (form == BS_BLOCK) {
      go([&] {
        run_variant<T, BS_BLOCK, BULK, SKEW, false, COPIES>(o, table, c, pl);
      }, "copies only", true);
      go([&] {
        run_variant<T, BS_BLOCK, BULK, SKEW, false, SCORING>(o, table, c, pl);
      }, "scoring only", true);
    } else {
      go([&] {
        run_variant<T, BS_ROWS, BULK, SKEW, false, COPIES>(o, table, c, pl);
      }, "copies only", true);
      go([&] {
        run_variant<T, BS_ROWS, BULK, SKEW, false, SCORING>(o, table, c, pl);
      }, "scoring only", true);
    }
  }
  // cycles a warp spends per item waiting, scoring and refilling
  for (const int w : {4, 8}) {
    const int vst = vstage(form, SKEW, c.D, elem);
    const Plan pl = plan(o.sms, c.B, c.E, c.F, c.D, elem, form, vst, w, 2);
    if (BS_HDR + (size_t)pl.warps * pl.ring * vst > (size_t)BS_MAX_SMEM)
      continue;
    unsigned long long zero[4] = {0, 0, 0, 0}, got[4];
    CK(cudaMemcpyToSymbol(g_probe, zero, sizeof zero));
    if (form == BS_BLOCK)
      run_variant<T, BS_BLOCK, BULK, SKEW, false, FULL, true>(o, table, c,
                                                              pl);
    else
      run_variant<T, BS_ROWS, BULK, SKEW, false, FULL, true>(o, table, c,
                                                             pl);
    CK(cudaMemcpyFromSymbol(got, g_probe, sizeof got));
    const double items = (double)std::max(1ull, got[3]);
    printf("%-18s probe          warps %d ring %2d: cycles an item a warp: "
           "wait %.0f, chain+epilogue %.0f, refill %.0f\n",
           c.label, pl.warps, pl.ring, got[0] / items, got[1] / items,
           got[2] / items);
  }
  var("fence", form, SKEW, [&](const Plan& pl) {
    if (form == BS_BLOCK)
      run_variant<T, BS_BLOCK, BULK, SKEW, true>(o, table, c, pl);
    else
      run_variant<T, BS_ROWS, BULK, SKEW, true>(o, table, c, pl);
  });
  if (form == BS_BLOCK && c.D * elem % COL == 0) {
    const int tst = BS_LANES * c.D * elem;
    for (const int w : {6, 8, 12, 16}) {
      const Plan pl = plan(o.sms, c.B, c.E, c.F, c.D, elem, form, tst, w, 1);
      if (BS_HDR + 1024 + (size_t)pl.warps * tst > (size_t)BS_MAX_SMEM)
        continue;
      report(o, c, "tensor2d", &pl, time_ms([&] {
               run_tensor<T>(o.q, o.qn, table, o.sqn, o.cand, o.n_blocks,
                             c.B, c.E, c.F, c.D, c.dtype, pl.warps, pl.ring,
                             pl.grid, pl.per_warp, o.got);
             }),
             bound);
    }
  }
  var("v1 skew", form, SKEW, [&](const Plan& pl) {
    if (form == BS_BLOCK)
      run_variant<T, BS_BLOCK, BULK, SKEW>(o, table, c, pl);
    else
      run_variant<T, BS_ROWS, BULK, SKEW>(o, table, c, pl);
  });
  var("skew/branch", form, SKEW, [&](const Plan& pl) {
    if (form == BS_BLOCK)
      run_variant<T, BS_BLOCK, BULK, SKEW_BRANCH>(o, table, c, pl);
    else
      run_variant<T, BS_ROWS, BULK, SKEW_BRANCH>(o, table, c, pl);
  });
  if (form == BS_BLOCK) {
    var("bulk/plain", BS_BLOCK, PLAIN, [&](const Plan& pl) {
      run_variant<T, BS_BLOCK, BULK, PLAIN>(o, table, c, pl);
    });
    var("cpasync/pad", BS_BLOCK, PAD, [&](const Plan& pl) {
      run_variant<T, BS_BLOCK, CPASYNC, PAD>(o, table, c, pl);
    });
    var("cpasync/skew", BS_BLOCK, SKEW, [&](const Plan& pl) {
      run_variant<T, BS_BLOCK, CPASYNC, SKEW>(o, table, c, pl);
    });
  } else {
    var("bulk/plain", BS_ROWS, PLAIN, [&](const Plan& pl) {
      run_variant<T, BS_ROWS, BULK, PLAIN>(o, table, c, pl);
    });
    var("cpasync/pad", BS_ROWS, PAD, [&](const Plan& pl) {
      run_variant<T, BS_ROWS, CPASYNC, PAD>(o, table, c, pl);
    });
    var("cpasync/skew", BS_ROWS, SKEW, [&](const Plan& pl) {
      run_variant<T, BS_ROWS, CPASYNC, SKEW>(o, table, c, pl);
    });
  }
  var("rows/skew", BS_ROWS, SKEW, [&](const Plan& pl) {
    run_variant<T, BS_ROWS, BULK, SKEW>(o, table, c, pl);
  });
  var("rows/pad", BS_ROWS, PAD, [&](const Plan& pl) {
    run_variant<T, BS_ROWS, BULK, PAD>(o, table, c, pl);
  });
}

}  // namespace

int main() {
  int sms = 0;
  CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  cudaDeviceProp prop;
  CK(cudaGetDeviceProperties(&prop, 0));
  printf("%s, %d SMs\n", prop.name, sms);
  const int N = 1000064, F = 32, D = 128, B = 2048, J = 512;
  const size_t nel = (size_t)N * F * D;
  float* x32;
  __half* x16;
  __nv_bfloat16* xb;
  float *sqn, *q, *qn, *ref, *got;
  int* cand;
  const size_t out_n = (size_t)B * J;  // = B * 16 * F
  CK(cudaMalloc(&x32, nel * 4));
  CK(cudaMalloc(&x16, nel * 2));
  CK(cudaMalloc(&xb, nel * 2));
  CK(cudaMalloc(&sqn, (size_t)N * F * 4));
  CK(cudaMalloc(&q, (size_t)B * D * 4));
  CK(cudaMalloc(&qn, B * 4));
  CK(cudaMalloc(&cand, (size_t)B * J * 4));
  CK(cudaMalloc(&ref, out_n * 4));
  CK(cudaMalloc(&got, out_n * 4));
  fill_gauss<<<4096, 256>>>(x32, nel, 1);
  narrow<__half><<<4096, 256>>>(x32, x16, nel);
  narrow<__nv_bfloat16><<<4096, 256>>>(x32, xb, nel);
  fill_gauss<<<1024, 256>>>(sqn, (size_t)N * F, 2);
  fill_gauss<<<256, 256>>>(q, (size_t)B * D, 3);
  fill_gauss<<<8, 256>>>(qn, B, 4);
  fill_ids<<<1024, 256>>>(cand, (size_t)B * J, N, 5);
  int* hot;
  CK(cudaMalloc(&hot, (size_t)B * J * 4));
  zero_odd<<<1024, 256>>>(cand, hot, (size_t)B * J);
  CK(cudaGetLastError());
  CK(cudaDeviceSynchronize());
  Ops o{q, qn, sqn, cand, ref, got, out_n, sms, N};
  const Case cases[] = {
      {"main f32", B, 16, F, D, 0},     {"main f16", B, 16, F, D, 1},
      {"main bf16", B, 16, F, D, 2},    {"B=16 f32", 16, 16, F, D, 0},
      {"B=16 f16", 16, 16, F, D, 1},    {"rows J=512 f32", B, J, 1, D, 0},
      {"rows J=512 f16", B, J, 1, D, 1}, {"rows J=16 f32", B, 16, 1, D, 0},
      {"rows J=16 f16", B, 16, 1, D, 1},
      {"rows J=512 hot f32", B, J, 1, D, 0, true},
      {"rows J=16 hot f32", B, 16, 1, D, 0, true},
  };
  for (const Case& c : cases) {
    o.cand = c.hot ? hot : cand;
    // rows cases index the table's first N rows (cand < N)
    if (c.dtype == 0) run_case<float>(o, x32, c);
    if (c.dtype == 1) run_case<__half>(o, x16, c);
    if (c.dtype == 2) run_case<__nv_bfloat16>(o, xb, c);
  }
  printf(o.all_equal ? "every form equals the first port's kernel\n"
                     : "MISMATCH against the first port's kernel\n");
  return o.all_equal ? 0 : 1;
}
