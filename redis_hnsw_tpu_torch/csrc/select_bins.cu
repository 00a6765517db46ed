// Kernel D: the one-pass certified select -- per-bin best rows and the
// global second-best bound.
//
// Replaces redis_hnsw_tpu/ops/pallas_select.py::select_bins (the
// pl.pallas_call at :189, _select_kernel :129, _bin_reduce :110). The rows
// are cut into bins of BIN_L = 128 consecutive rows. Per query b and bin j
// it emits
//
//   sims[b, j] = max1, the bin's best score;
//   ids[b, j]  = the row id of max1 (the lowest id on ties);
//
// and per query
//
//   m2[b] = the max over all bins of the bin's best score with that ONE
//           element removed (a duplicate of max1 at another row counts).
//
// Every row outside the candidate set scores <= m2, so a stable top-k over
// the candidates whose k-th score t exceeds m2 is the exact top-k of the
// whole table (ops/scan.py _certified_onepass). That argument ranks the
// candidates by kernel A's own scores, so every score here is, bit for
// bit, kernel A's: both score on the fp32 core of l2_core.cuh (one
// in-order __fmaf_rn chain over d from +0, then l2_score), whose
// comment gives the chain, the tiling and the ring.
//
// Bound on the H100: 2*B*N*D fp32 operations against (B + N)*D*4 bytes
// read plus B*N/128*8 bytes of bins written -- compute-bound at the
// serving shape (7.8 ms at B = 2048, N = 1M, D = 128). There are no
// tensor cores on purpose: TF32, 3xTF32 or bf16 splits, split-K and any
// reassociation round otherwise than kernel A's chain, and the one-pass
// certificate and its byte-identity with the exact tier need the same
// bits. So the design aims at the fp32 FMA pipes:
//
// * One block tile of the core is 128 queries x 128 rows = one bin; a
//   thread holds an 8 x 16 register tile (queries ty + 16i, rows
//   tx + 8j), 32 FMAs per 16-byte shared-memory load.
// * The cp.async ring runs on across bins, so the next bin's first
//   chunks load during this bin's last ones and its epilogue. The query
//   norms are copied once per block, and each bin's row norms with its
//   first chunk into a STAGES-deep ring of their own, so the epilogue
//   reads no device memory (reading them there cost ~4% on the H100).
// * The epilogue runs once per bin: finish the 128 scores, fold each
//   query's 16 rows in ascending row order (a strict > keeps the lowest
//   index), then three 3-round shuffle reductions over the 8 lanes that
//   share the query: the max, the lowest in-bin index holding it, the max
//   of everything else (the winner's lane gives its second best, the
//   others their best). One lane writes (max1, id) and folds m2 into the
//   block's running m2 per query, kept in shared memory: a thread's
//   registers (near the 255 limit) go to the FMA loop.
//
// Blocks run in no order, so m2 is reduced across them in a second pass:
// each block writes one partial per query and split, and m2_reduce_kernel
// takes their max. ops/cuda_select.py chooses the splits from the card's
// resident block slots (select_bins_slots) so that the waves of blocks
// come out even.
//
// C interface (ctypes, ops/cuda_select.py): select_bins_launch returns
// cudaGetLastError(), select_bins_slots a negative value on failure.

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "l2_core.cuh"

namespace rht_select {

using namespace rht_l2;

constexpr int BIN_L = TILE_R;  // rows per bin = rows per block tile
// the operand ring, the tile's query norms, a ring of row norms, and the
// tile's running m2
constexpr int SMEM_FLOATS = STAGES * STAGE_FLOATS + 2 * TILE_Q + STAGES * BIN_L;
constexpr int SMEM_BYTES = SMEM_FLOATS * (int)sizeof(float);

template <int VEC>
__global__ void __launch_bounds__(THREADS, 2)
    select_bins_kernel(const float* __restrict__ Q,
                       const float* __restrict__ X,
                       const float* __restrict__ qq,
                       const float* __restrict__ sq, int B, int N, int D,
                       int nbins, int bins_per_split,
                       float* __restrict__ sims, int* __restrict__ ids,
                       float* __restrict__ m2_part) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * TILE_Q;
  const int split = blockIdx.y;
  const int b_begin = split * bins_per_split;
  const int b_end = min(nbins, b_begin + bins_per_split);
  const int kch = max(1, (D + K_CHUNK - 1) / K_CHUNK);
  const int total = max(0, b_end - b_begin) * kch;
  const int tx = threadIdx.x % TR;
  const int ty = threadIdx.x / TR;

  float* const qq_s = smem + STAGES * STAGE_FLOATS;
  float* const sq_s = qq_s + TILE_Q;  // bin b's row norms at b % STAGES
  float* const m2_s = sq_s + STAGES * BIN_L;
  m2_s[threadIdx.x] = -CUDART_INF_F;
  auto load = [&](int c) {
    const int bin = b_begin + c / kch;
    const int part = c % kch;
    load_chunk<VEC>(smem + (c % STAGES) * STAGE_FLOATS, Q, X, B, N, D, q0,
                    bin * BIN_L, part * K_CHUNK);
    if (part == 0) {
      const int r = bin * BIN_L + threadIdx.x;
      cp_async<1>(sq_s + (bin % STAGES) * BIN_L + threadIdx.x,
                  r < N ? sq + r : sq, r < N ? 4 : 0);
    }
  };
  {
    const int qi = q0 + threadIdx.x;  // zero past B
    cp_async<1>(qq_s + threadIdx.x, qi < B ? qq + qi : qq, qi < B ? 4 : 0);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }

  float acc[MQ][MR];
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int j = 0; j < MR; ++j) acc[i][j] = 0.f;

  int kc = 0;
  int bin = b_begin;
  for (int c = 0; c < total; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed (this thread's part)
    __syncthreads();  // ... everyone's; and chunk c - 1's slot is free
    if (c + STAGES - 1 < total) load(c + STAGES - 1);
    cp_async_commit();
    fma_chunk(smem + (c % STAGES) * STAGE_FLOATS, tx, ty, acc);
    if (++kc < kch) continue;

    // the bin is scored: reduce it (no device memory read)
    const int r0 = bin * BIN_L;
    const float* const sq_bin = sq_s + (bin % STAGES) * BIN_L;
    float sn[MR];
#pragma unroll
    for (int j = 0; j < MR; ++j) {
      const int r = tx + j * TR;
      sn[j] = r0 + r < N ? sq_bin[r] : CUDART_INF_F;  // rows >= N: -inf
    }
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      const int qi = q0 + ty + i * TQ;
      const float qn = qq_s[ty + i * TQ];
      float a1 = -CUDART_INF_F, a2 = -CUDART_INF_F;
      int aj = 0;
#pragma unroll
      for (int j = 0; j < MR; ++j) {
        const float s = l2_score(acc[i][j], qn, sn[j]);
        if (j == 0 || s > a1) {
          a2 = a1;
          a1 = s;
          aj = j;
        } else {
          a2 = s > a2 ? s : a2;
        }
        acc[i][j] = 0.f;
      }
      const int idx = tx + aj * TR;  // in-bin index of a1
      float m1 = a1;
#pragma unroll
      for (int off = TR / 2; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(FULL_MASK, m1, off);
        m1 = o > m1 ? o : m1;
      }
      int win = a1 == m1 ? idx : BIN_L;
#pragma unroll
      for (int off = TR / 2; off > 0; off >>= 1) {
        win = min(win, __shfl_xor_sync(FULL_MASK, win, off));
      }
      float m2 = idx == win ? a2 : a1;
#pragma unroll
      for (int off = TR / 2; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(FULL_MASK, m2, off);
        m2 = o > m2 ? o : m2;
      }
      if (tx == 0) {
        float& run_m2 = m2_s[ty + i * TQ];
        run_m2 = m2 > run_m2 ? m2 : run_m2;
        if (qi < B) {
          sims[(size_t)qi * nbins + bin] = m1;
          ids[(size_t)qi * nbins + bin] = r0 + win;
        }
      }
    }
    kc = 0;
    ++bin;
  }
  cp_async_wait<0>();  // no copy outlives the block (an empty split)
  __syncthreads();
  const int qi = q0 + threadIdx.x;
  if (qi < B) m2_part[(size_t)split * B + qi] = m2_s[threadIdx.x];
}

__global__ void m2_reduce_kernel(const float* __restrict__ m2_part, int B,
                                 int splits, float* __restrict__ m2) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B) return;
  float m = -CUDART_INF_F;
  for (int sp = 0; sp < splits; ++sp) {
    const float v = m2_part[(size_t)sp * B + q];
    m = v > m ? v : m;
  }
  m2[q] = m;
}

template <int VEC>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(select_bins_kernel<VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

template <int VEC>
int blocks_per_sm() {
  int n = 0;
  if (allow_smem<VEC>() != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, select_bins_kernel<VEC>, THREADS, SMEM_BYTES) != cudaSuccess) {
    return -1;
  }
  return n;
}

}  // namespace rht_select

// Resident blocks of kernel D the current card holds at once (the fewer
// of its two forms), or a negative value on failure.
extern "C" int select_bins_slots() {
  using namespace rht_select;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return -1;
  }
  const int a = blocks_per_sm<4>();
  const int b = blocks_per_sm<1>();
  if (a <= 0 || b <= 0) return -1;
  return (a < b ? a : b) * sms;
}

// The dynamic shared memory of one block, in bytes.
extern "C" int select_bins_smem_bytes() { return rht_select::SMEM_BYTES; }

extern "C" int select_bins_launch(const float* q, const float* x,
                                  const float* qq, const float* sq, int B,
                                  int N, int D, int splits, float* sims,
                                  int* ids, float* m2_part, float* m2,
                                  cudaStream_t stream) {
  using namespace rht_select;
  if (B <= 0 || N <= 0) return 0;
  const int nbins = (N + BIN_L - 1) / BIN_L;
  if (splits < 1 || splits > nbins || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int bins_per_split = (nbins + splits - 1) / splits;
  const dim3 grid((B + TILE_Q - 1) / TILE_Q, splits);
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err = vec4 ? allow_smem<4>() : allow_smem<1>();
  if (err != cudaSuccess) return (int)err;
  if (vec4) {
    select_bins_kernel<4><<<grid, THREADS, SMEM_BYTES, stream>>>(
        q, x, qq, sq, B, N, D, nbins, bins_per_split, sims, ids, m2_part);
  } else {
    select_bins_kernel<1><<<grid, THREADS, SMEM_BYTES, stream>>>(
        q, x, qq, sq, B, N, D, nbins, bins_per_split, sims, ids, m2_part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  m2_reduce_kernel<<<(B + 255) / 256, 256, 0, stream>>>(m2_part, B, splits,
                                                         m2);
  return (int)cudaGetLastError();
}
