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
// f32 as they are read), then explicitly rounded __fmul_rn / __fsub_rn:
// its value depends only on q[b], the row's elements and its sqnorm --
// never on (e, f), the block, the form or which parent held it. The row
// form of the same function (F = 1, ops/cuda_gather.py fused_row_score)
// therefore scores the entry point and seeds bit-identically too. Nothing
// is split over d, reassociated, or run on tensor cores.
//
// Bound on the H100: every (b, e) reads one [F, D] block once -- at the
// main shape (B = 2048, E = 16, F = 32, D = 128) 537 MB in f32, 268 MB in
// f16, against 2*B*E*F*D = 2.7e8 operations -- so it is bound by HBM
// bytes (3.35 TB/s: ~0.16 ms f32, ~0.08 ms f16). The design keeps bytes
// in flight and keeps shared memory off the critical path:
//
// * An item is 32 rows, one per lane of a warp: 32 rows of one block
//   (BS_BLOCK; a block of F > 32 rows is ceil(F/32) items) or 32
//   consecutive outputs of the flattened [B, E*F] (BS_ROWS: the row form
//   F = 1 and small F; each row copied on its own, so a J = 16 descent
//   step fills every lane, and lanes asking for one row share a copy).
// * Every warp owns a ring of `ring` stages in dynamic shared memory and
//   walks a contiguous range of items (persistent blocks, one per SM,
//   planned by ops/cuda_gather.py plan()). It keeps the next ring - 1
//   items' copies in flight while it scores one -- and the SM keeps one
//   item a warp in flight for up to 16 warps -- with Hopper's bulk
//   asynchronous copy (cp.async.bulk, the TMA engine without a tensor
//   map): in the block form one copy of the item's contiguous rows and
//   one of q[b]; in the row form one copy per row, issued by the 32 lanes
//   together. Each stage completes on its mbarrier by expect-tx: one
//   arrival (lane 0's, with the item's bytes) and the copies' bytes. A
//   warp refills only the stage it has just read, so there is no
//   __syncthreads and no empty barrier.
// * Shared memory reads free of bank conflicts. A block's rows land at a
//   stride of D * elem bytes (a multiple of 128 at D = 128), so lanes
//   reading their own rows at the same d would all hit one bank group:
//   lane l runs its chain (l & 7) 16-byte steps late instead, so the 8
//   lanes of a quarter warp read 8 different columns, of the rows and of
//   the staged q[b] (only the timing shifts; each chain still runs d = 0
//   .. D-1 in order; the loop is branch-free, a step outside the row
//   reading a wrapped column whose result a select discards, so later
//   steps' loads issue ahead of the chain). Row copies land an odd number
//   of 16-byte units apart, so the row form reads unskewed and its q,
//   read through L1, is a broadcast. f16/bf16 are widened as they are
//   read (exact), so a stage holds half the bytes of f32.
// * nbrsqn and qn ride a register pipeline one item ahead of the chain
//   (the ids two items ahead), so the epilogue never waits on a load.
// * The general form (BS_DIRECT) serves what the copies cannot: a row of
//   D * elem % 16 != 0 bytes, an operand off a 16-byte boundary, or a
//   ring too large for shared memory. One thread an output, its row read
//   straight from the table in order. Same chain, same bits.
//
// tools/block_score_study.cu times this kernel beside the port's first
// kernel C (which it must equal bit for bit on Gaussian data) and beside
// other copy engines and layouts (2D tensor copies into the 128-byte
// swizzle, 16-byte cp.async into padded rows); PERF.md has the numbers.
//
// C interface (ctypes, ops/cuda_gather.py): cand must be in range; dtype
// 0 = f32, 1 = f16, 2 = bf16; form / warps / ring / grid / per_warp come
// from the wrapper's planner, and the launch re-checks what the form
// needs. Returns cudaGetLastError() (or cudaErrorInvalidValue for a plan
// the kernel cannot run).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rht {

constexpr int BS_LANES = 32;      // rows an item: one a lane
constexpr int BS_MAX_WARPS = 16;  // warps a block, each with its own ring
constexpr int BS_MAX_RING = 16;   // stages a warp
constexpr int BS_HDR = BS_MAX_WARPS * BS_MAX_RING * 8;  // mbarriers, bytes
constexpr int BS_MAX_SMEM = 232448;  // dynamic shared memory a block
constexpr int BS_DIRECT_THREADS = 256;
enum { BS_DIRECT = 0, BS_BLOCK = 1, BS_ROWS = 2 };

// 16-byte units between two staged rows of the row form: odd, so the 8
// lanes of a quarter warp reading one column hit 8 different bank groups.
__host__ __device__ constexpr int bs_pitch16(int D, int elem) {
  return (D * elem / 16) | 1;
}

// Bytes of one stage, rounded up to 128: the block form's 32 rows and
// q[b] after them; the row form's 32 pitched rows and, after them, the
// lane whose copy each lane reads (one byte a lane).
__host__ __device__ constexpr int bs_stage_bytes(int form, int D, int elem) {
  return ((form == BS_BLOCK ? BS_LANES * D * elem + D * 4
                            : BS_LANES * bs_pitch16(D, elem) * 16 + BS_LANES) +
          127) /
         128 * 128;
}

// Dynamic shared memory of a block: barriers, then the warps' rings.
__host__ __device__ constexpr int bs_smem_bytes(int form, int D, int elem,
                                                int warps, int ring) {
  return BS_HDR + warps * ring * bs_stage_bytes(form, D, elem);
}

// -- element widening (exact) ---------------------------------------------

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The lower half of a word is the earlier element.
__device__ __forceinline__ float half_lo(unsigned w) {
  return __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
}
__device__ __forceinline__ float half_hi(unsigned w) {
  return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}
// bf16 -> f32 is exact: the bf16 bits are the f32's upper half
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// dot advanced in order over the 16 bytes `raw` of T against qv[0 ..).
template <typename T>
__device__ __forceinline__ float fma16(const uint4& raw, const float* qv,
                                       float dot);

template <>
__device__ __forceinline__ float fma16<float>(const uint4& raw,
                                              const float* qv, float dot) {
  const float4 a = *reinterpret_cast<const float4*>(qv);
  dot = __fmaf_rn(a.x, __uint_as_float(raw.x), dot);
  dot = __fmaf_rn(a.y, __uint_as_float(raw.y), dot);
  dot = __fmaf_rn(a.z, __uint_as_float(raw.z), dot);
  return __fmaf_rn(a.w, __uint_as_float(raw.w), dot);
}

template <>
__device__ __forceinline__ float fma16<__half>(const uint4& raw,
                                               const float* qv, float dot) {
  const float4 a = *reinterpret_cast<const float4*>(qv);
  const float4 b = *reinterpret_cast<const float4*>(qv + 4);
  dot = __fmaf_rn(a.x, half_lo(raw.x), dot);
  dot = __fmaf_rn(a.y, half_hi(raw.x), dot);
  dot = __fmaf_rn(a.z, half_lo(raw.y), dot);
  dot = __fmaf_rn(a.w, half_hi(raw.y), dot);
  dot = __fmaf_rn(b.x, half_lo(raw.z), dot);
  dot = __fmaf_rn(b.y, half_hi(raw.z), dot);
  dot = __fmaf_rn(b.z, half_lo(raw.w), dot);
  return __fmaf_rn(b.w, half_hi(raw.w), dot);
}

template <>
__device__ __forceinline__ float fma16<__nv_bfloat16>(const uint4& raw,
                                                      const float* qv,
                                                      float dot) {
  const float4 a = *reinterpret_cast<const float4*>(qv);
  const float4 b = *reinterpret_cast<const float4*>(qv + 4);
  dot = __fmaf_rn(a.x, bf16_lo(raw.x), dot);
  dot = __fmaf_rn(a.y, bf16_hi(raw.x), dot);
  dot = __fmaf_rn(a.z, bf16_lo(raw.y), dot);
  dot = __fmaf_rn(a.w, bf16_hi(raw.y), dot);
  dot = __fmaf_rn(b.x, bf16_lo(raw.z), dot);
  dot = __fmaf_rn(b.y, bf16_hi(raw.z), dot);
  dot = __fmaf_rn(b.z, bf16_lo(raw.w), dot);
  return __fmaf_rn(b.w, bf16_hi(raw.w), dot);
}

__device__ __forceinline__ float epilogue(float dot, float qnb, float fn) {
  return __fsub_rn(__fsub_rn(__fmul_rn(2.f, dot), qnb), fn);
}

// -- mbarriers and bulk copies (PTX) --------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of parity `parity` to complete. A copy that never
// lands (a fault in the plan) traps after 2^22 polls instead of hanging.
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
    if (polls == (1u << 22)) __trap();
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// src to shared dst, completing on bar's transaction count.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -- the bulk-copy forms ---------------------------------------------------

// One lane's chain over its staged row x of nv 16-byte steps. BS_BLOCK:
// run `skew` steps late, q[b] staged (see the header); BS_ROWS: in order,
// q read through L1 (every lane of the warp at the same column).
template <typename T, int FORM>
__device__ __forceinline__ float row_dot(const float* qrow,
                                         const unsigned char* x, int nv,
                                         int skew) {
  constexpr int PER = 16 / sizeof(T);  // elements a 16-byte step
  float dot = 0.f;
  if constexpr (FORM == BS_BLOCK) {
    int v = -skew;
    int col = ((v % nv) + nv) % nv;  // v's column, wrapped into the row
#pragma unroll 8
    for (int i = 0; i < nv + 7; ++i) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + col * 16);
      const float next = fma16<T>(raw, qrow + col * PER, dot);
      dot = (unsigned)v < (unsigned)nv ? next : dot;
      ++v;
      col = col + 1 == nv ? 0 : col + 1;
    }
  } else {
#pragma unroll 8
    for (int v = 0; v < nv; ++v) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + v * 16);
      dot = fma16<T>(raw, qrow + v * PER, dot);
    }
  }
  return dot;
}

template <typename T, int FORM>
__global__ void __launch_bounds__(BS_MAX_WARPS * 32)
    block_score_kernel(const float* __restrict__ q,
                       const float* __restrict__ qn,
                       const T* __restrict__ nbrvec,
                       const float* __restrict__ nbrsqn,
                       const int* __restrict__ cand, int E, int F, int D,
                       long long items, long long rows, long long per_warp,
                       int ring, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long first =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * per_warp;
  const long long last = min(items, first + per_warp);
  if (first >= last) return;
  const int row_bytes = D * (int)sizeof(T);
  const int nv = row_bytes / 16;
  const int pitch = bs_pitch16(D, sizeof(T)) * 16;
  const int stage = bs_stage_bytes(FORM, D, sizeof(T));
  const int chunks = (F + BS_LANES - 1) / BS_LANES;  // items a block
  unsigned char* const ring0 = smem + BS_HDR + (size_t)warp * ring * stage;
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem) + warp * BS_MAX_RING;
  if (lane < ring) mbar_init(bar + lane, 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncwarp();

  // Item `it` as this lane sees it: its output slot, its query, its row
  // f of its block, whether it has one, and where its block's id is.
  struct Lane {
    long long slot, b, p;
    int f;
    bool live;
  };
  auto lane_of = [&](long long it) -> Lane {
    if constexpr (FORM == BS_ROWS) {
      const long long slot = it * BS_LANES + lane;
      const long long p = slot < rows ? slot / F : 0;
      return Lane{slot, p / E, p, (int)(slot - p * F), slot < rows};
    } else {
      const long long p = it / chunks;
      const int f = (int)(it - p * chunks) * BS_LANES + lane;
      return Lane{p * F + f, p / E, p, f, f < F};
    }
  };
  // Item `it`'s copies into stage s (id: the lane's block, loaded a
  // whole item ahead). Lane 0 arrives with every byte the item brings.
  auto issue = [&](long long it, int s, int id) {
    unsigned char* st = ring0 + (size_t)s * stage;
    uint64_t* bs = bar + s;
    const Lane l = lane_of(it);
    if constexpr (FORM == BS_ROWS) {
      // Lanes asking for one row (a masked slot clamped to row 0, a node
      // in many frontiers) share one copy: the lowest of them copies, the
      // others read its slot. A hot row would otherwise be fetched once a
      // lane, every copy queued on the same L2 lines.
      const size_t row = (size_t)id * F + l.f;
      const unsigned same =
          __match_any_sync(0xffffffffu, l.live ? row : ~(size_t)lane);
      const int leader = __ffs(same) - 1;
      const unsigned copies = __ballot_sync(0xffffffffu, l.live &&
                                                             leader == lane);
      st[BS_LANES * pitch + lane] = (unsigned char)leader;
      if (lane == 0) mbar_arrive_tx(bs, __popc(copies) * row_bytes);
      if (copies >> lane & 1)
        bulk_g2s(st + lane * pitch, nbrvec + row * D, row_bytes, bs);
    } else if (lane == 0) {
      const int nr = min(BS_LANES, F - l.f);
      mbar_arrive_tx(bs, nr * row_bytes + D * 4);
      bulk_g2s(st, nbrvec + ((size_t)id * F + l.f) * D, nr * row_bytes, bs);
      bulk_g2s(st + BS_LANES * row_bytes, q + (size_t)l.b * D, D * 4, bs);
    }
  };

  for (int s = 0; s < ring && first + s < last; ++s)
    issue(first + s, s, cand[lane_of(first + s).p]);
  // the scalar pipeline: ids two items ahead, sqnorms one item ahead
  Lane l = lane_of(first);
  float fn = l.live ? nbrsqn[(size_t)cand[l.p] * F + l.f] : 0.f;
  float qnb = qn[l.b];
  int id_next = first + 1 < last ? cand[lane_of(first + 1).p] : 0;
  int s = 0;
  uint32_t parity = 0;
  for (long long it = first; it < last; ++it) {
    const bool more = it + 1 < last;
    const Lane l1 = lane_of(more ? it + 1 : it);
    const float fn1 = more && l1.live ? nbrsqn[(size_t)id_next * F + l1.f]
                                      : 0.f;
    const float qnb1 = qn[l1.b];
    const int id_after = it + 2 < last ? cand[lane_of(it + 2).p] : 0;
    const bool refill = it + ring < last;
    const int refill_id = refill ? cand[lane_of(it + ring).p] : 0;
    const unsigned char* st = ring0 + (size_t)s * stage;
    mbar_wait(bar + s, parity);
    if (l.live) {
      const float dot =
          FORM == BS_ROWS
              ? row_dot<T, FORM>(q + (size_t)l.b * D,
                                 st + st[BS_LANES * pitch + lane] * pitch, nv,
                                 0)
              : row_dot<T, FORM>(
                    reinterpret_cast<const float*>(st + BS_LANES * row_bytes),
                    st + lane * row_bytes, nv, lane & 7);
      out[l.slot] = epilogue(dot, qnb, fn);
    }
    // every lane's reads of the stage are done (their values are in the
    // chain), so the next copy may overwrite it
    __syncwarp();
    if (refill) issue(it + ring, s, refill_id);
    if (++s == ring) {
      s = 0;
      parity ^= 1;
    }
    l = l1;
    fn = fn1;
    qnb = qnb1;
    id_next = id_after;
  }
}

// -- the general form ------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(BS_DIRECT_THREADS)
    block_score_direct(const float* __restrict__ q,
                       const float* __restrict__ qn,
                       const T* __restrict__ nbrvec,
                       const float* __restrict__ nbrsqn,
                       const int* __restrict__ cand, int E, int F, int D,
                       long long rows, float* __restrict__ out) {
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < rows; r += (long long)gridDim.x * blockDim.x) {
    const long long p = r / F;
    const int f = (int)(r - p * F);
    const long long b = p / E;
    const size_t row = (size_t)cand[p] * F + f;
    const T* x = nbrvec + row * D;
    const float* qr = q + (size_t)b * D;
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = __fmaf_rn(qr[d], widen(x[d]), dot);
    out[r] = epilogue(dot, qn[b], nbrsqn[row]);
  }
}

template <typename T>
int launch_typed(const float* q, const float* qn, const void* nbrvec,
                 const float* nbrsqn, const int* cand, int B, int E, int F,
                 int D, int form, int warps, int ring, int grid,
                 long long per_warp, float* out, cudaStream_t stream) {
  const T* nv = static_cast<const T*>(nbrvec);
  const long long rows = (long long)B * E * F;
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  if (form == BS_DIRECT) {
    block_score_direct<T><<<grid, BS_DIRECT_THREADS, 0, stream>>>(
        q, qn, nv, nbrsqn, cand, E, F, D, rows, out);
    return (int)cudaGetLastError();
  }
  if ((form != BS_BLOCK && form != BS_ROWS) || D * sizeof(T) % 16 != 0 ||
      (uintptr_t)nbrvec % 16 != 0 || (uintptr_t)q % 16 != 0 || warps < 1 ||
      warps > BS_MAX_WARPS || ring < 1 || ring > BS_MAX_RING)
    return (int)cudaErrorInvalidValue;
  const int smem = bs_smem_bytes(form, D, sizeof(T), warps, ring);
  const long long items = form == BS_ROWS
                              ? (rows + BS_LANES - 1) / BS_LANES
                              : (long long)B * E *
                                    ((F + BS_LANES - 1) / BS_LANES);
  if (smem > BS_MAX_SMEM || per_warp < 1 ||
      (long long)grid * warps * per_warp < items)
    return (int)cudaErrorInvalidValue;
  auto kern = &block_score_kernel<T, BS_BLOCK>;
  if (form == BS_ROWS) kern = &block_score_kernel<T, BS_ROWS>;
  // Raise the kernel's shared memory limit once a device, not on every
  // launch (nor inside a CUDA graph's capture).
  static unsigned raised[2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(raised[form - 1] >> dev & 1)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BS_MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) raised[form - 1] |= 1u << dev;
  }
  kern<<<grid, warps * 32, smem, stream>>>(q, qn, nv, nbrsqn, cand, E, F, D,
                                           items, rows, per_warp, ring, out);
  return (int)cudaGetLastError();
}

template <typename T>
int slots_typed(int form, int warps, int smem) {
  auto kern = &block_score_kernel<T, BS_BLOCK>;
  if (form == BS_ROWS) kern = &block_score_kernel<T, BS_ROWS>;
  int dev = 0, sms = 0, per = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           BS_MAX_SMEM) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, warps * 32,
                                                    smem) != cudaSuccess)
    return -1;
  return per * sms;
}

}  // namespace rht

extern "C" int block_score_launch(const float* q, const float* qn,
                                  const void* nbrvec, const float* nbrsqn,
                                  const int* cand, int B, int E, int F,
                                  int D, int dtype, int form, int warps,
                                  int ring, int grid, long long per_warp,
                                  float* out, cudaStream_t stream) {
  using namespace rht;
  if (B <= 0 || E <= 0 || F <= 0) return 0;
  if (D <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_typed<float>(q, qn, nbrvec, nbrsqn, cand, B, E, F, D,
                                 form, warps, ring, grid, per_warp, out,
                                 stream);
    case 1:
      return launch_typed<__half>(q, qn, nbrvec, nbrsqn, cand, B, E, F, D,
                                  form, warps, ring, grid, per_warp, out,
                                  stream);
    case 2:
      return launch_typed<__nv_bfloat16>(q, qn, nbrvec, nbrsqn, cand, B, E,
                                         F, D, form, warps, ring, grid,
                                         per_warp, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Shared memory of one block of a bulk form (the planner's reckoning is
// tested against it).
extern "C" int block_score_smem_bytes(int form, int D, int dtype, int warps,
                                      int ring) {
  return rht::bs_smem_bytes(form, D, dtype == 0 ? 4 : 2, warps, ring);
}

// Blocks of a bulk form's plan resident on the current card at once
// (chip_smoke.py logs it), or -1.
extern "C" int block_score_slots(int form, int D, int dtype, int warps,
                                 int ring) {
  using namespace rht;
  const int smem = block_score_smem_bytes(form, D, dtype, warps, ring);
  switch (dtype) {
    case 0:
      return slots_typed<float>(form, warps, smem);
    case 1:
      return slots_typed<__half>(form, warps, smem);
    case 2:
      return slots_typed<__nv_bfloat16>(form, warps, smem);
    default:
      return -1;
  }
}
