// Kernel C: fused block gather + score for the graph beam's frontier.
//
// Replaces redis_hnsw_tpu/ops/pallas_gather.py::fused_block_score (the
// pl.pallas_call at :109, body _kernel :50). For lane b and candidate e of
// cand [B, E], the candidate's neighbour block nbrvec[cand[b, e]] is one
// contiguous [F, D] slab of the snapshot (f32, f16 or bf16), and
//
//   sims[b, e*F + f] = ((2 * dot) - qn[b]) - nbrsqn[cand[b, e], f]
//   dot = q[b] . nbrvec[cand[b, e], f]
//
// with nbrsqn the neighbour's exact f32 sqnorm (the JAX package's default
// scorer, ops/distance.py block_neg_sq_l2; the Pallas kernel recomputes
// |x|^2 from the block instead). The caller masks stale slots to -inf.
//
// Position independence: the beam's dedup keeps one copy of a node only
// because every re-proposal of it carries a bit-identical sim, and a node
// sits in the blocks of many parents. So each output is one thread's
// in-order __fmaf_rn chain over d = 0 .. D-1 from +0 (elements widened to
// f32 first), then explicitly rounded __fmul_rn / __fsub_rn, as in
// l2_core.cuh: its value depends only on q[b], the row's elements and its
// sqnorm -- never on (e, f), the block, or which parent held it. The row
// form of the same function (F = 1, ops/cuda_gather.py fused_row_score)
// therefore scores the entry point and seeds bit-identically too.
//
// Bound on the H100: every (b, e) reads one [F, D] block once -- at the
// main shape (B = 2048, E = 16, F = 32, D = 128) 537 MB in f32, 268 MB in
// f16, against 2*B*E*F*D = 2.7e8 operations -- so it is bound by HBM
// bytes (3.35 TB/s: ~0.16 ms f32, ~0.08 ms f16). Design: one block of
// threads per (lane, group of G candidates), one thread per (e, f) output
// (G*F <= MAX_ROWS threads). The group's rows are staged TILE_D dims at a
// time into shared memory with coalesced 16-byte loads (consecutive
// threads read consecutive 16 bytes of a row), widened to f32; q[b]'s
// chunk is staged beside them. Rows are padded to TILE_D + 4 floats, so
// each thread's float4 reads of its own row are free of bank conflicts.
// Not tuned: no cp.async/TMA pipelining, no tensor cores.
//
// C interface (ctypes, ops/cuda_gather.py): cand must be in range; dtype
// 0 = f32, 1 = f16, 2 = bf16; vec16 = 1 when every row chunk is 16-byte
// aligned (the wrapper checks). Returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rht {

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

}  // namespace rht

extern "C" int block_score_launch(const float* q, const float* qn,
                                  const void* nbrvec, const float* nbrsqn,
                                  const int* cand, int B, int E, int F,
                                  int D, int dtype, int vec16, float* out,
                                  cudaStream_t stream) {
  using namespace rht;
  if (B <= 0 || E <= 0 || F <= 0) return 0;
  if (F > BS_MAX_ROWS || D <= 0 || (E + (BS_MAX_ROWS / F) - 1) /
                                           (BS_MAX_ROWS / F) > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_typed<float>(q, qn, nbrvec, nbrsqn, cand, B, E, F, D,
                                 vec16, out, stream);
    case 1:
      return launch_typed<__half>(q, qn, nbrvec, nbrsqn, cand, B, E, F, D,
                                  vec16, out, stream);
    case 2:
      return launch_typed<__nv_bfloat16>(q, qn, nbrvec, nbrsqn, cand, B, E,
                                         F, D, vec16, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
