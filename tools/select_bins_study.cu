// Design study of kernel D (redis_hnsw_tpu_torch/csrc/select_bins.cu):
// the shipped kernel beside variants of its tiling, timed at the main
// path's shape (B = 2048 queries, N = 1,000,064 rows, D = 128) on
// synthetic data, every variant's outputs compared with the shipped
// kernel's byte for byte (they compute the same FMA chains).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o /tmp/select_bins_study tools/select_bins_study.cu
//   /tmp/select_bins_study
//
// One line per variant: registers, local memory (spills), resident blocks
// per SM, splits, ms per launch (best of 3 runs of 5 launches, CUDA
// events) and whether the outputs equal the shipped kernel's. Variants
// marked "timing only" skip work and give other outputs by design.

#include "../redis_hnsw_tpu_torch/csrc/select_bins.cu"

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
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

namespace study {

using rht_select::BIN_L;
using rht_select::cp_async;
using rht_select::cp_async_commit;
using rht_select::cp_async_wait;

// Variant knobs: a TQ x TR thread grid with MQ x MR register tiles
// (queries ty + TQ*i, rows tx + TR*j), MINB blocks per SM in the launch
// bounds, KC-dim chunks in an ST-deep ring, the dim loop unrolled by UNR
// (KC / 4 = fully), and FL flags: NORMS_SMEM stages the norms in shared
// memory, M2_SMEM keeps the running m2 there instead of in registers,
// NO_EPILOGUE replaces the bin reduction by a sum (timing only).
constexpr int NORMS_SMEM = 1, NO_EPILOGUE = 2, M2_SMEM = 4;

template <int TQ, int TR, int MQ, int MR, int MINB, int KC, int ST, int UNR,
          int FL>
struct V {
  static constexpr int THREADS = TQ * TR;
  static constexpr int CHUNK = KC;
  static constexpr int TILEQ = TQ * MQ;
  static constexpr int LD = KC + 4;
  static constexpr int ROWS = TILEQ + BIN_L;
  static constexpr int FLOATS = ROWS * LD;
  static constexpr int SMEM = (ST * FLOATS + 2 * TILEQ + ST * BIN_L) * 4;
  static_assert(TR * MR == BIN_L, "one bin per tile");
};

template <class C>
__device__ __forceinline__ void load_chunk(float* stage, const float* Q,
                                           const float* X, int B, int N,
                                           int D, int q0, int r0, int d0) {
  constexpr int PER_ROW = C::CHUNK / 4;  // 16-byte copies per row
  constexpr int RPP = C::THREADS / PER_ROW;
  const int col = threadIdx.x % PER_ROW;
  const int d = d0 + col * 4;
#pragma unroll
  for (int p = 0; p < C::ROWS / RPP; ++p) {
    const int r = threadIdx.x / PER_ROW + p * RPP;
    const bool is_q = p < C::TILEQ / RPP;
    const int g = is_q ? q0 + r : r0 + r - C::TILEQ;
    const float* base = is_q ? Q : X;
    const bool ok = g < (is_q ? B : N) && d < D;
    cp_async<4>(stage + r * C::LD + col * 4,
                ok ? base + (size_t)g * D + d : base, ok ? 16 : 0);
  }
}

template <int TQ, int TR, int MQ, int MR, int MINB, int KC, int ST, int UNR,
          int FL>
__global__ void __launch_bounds__(TQ * TR, MINB)
    kern(const float* __restrict__ Q, const float* __restrict__ X,
         const float* __restrict__ qq, const float* __restrict__ sq, int B,
         int N, int D, int nbins, int bps, float* __restrict__ sims,
         int* __restrict__ ids, float* __restrict__ m2_part) {
  using C = V<TQ, TR, MQ, MR, MINB, KC, ST, UNR, FL>;
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * C::TILEQ;
  const int split = blockIdx.y;
  const int b_begin = split * bps;
  const int b_end = min(nbins, b_begin + bps);
  const int kch = max(1, (D + KC - 1) / KC);
  const int total = max(0, b_end - b_begin) * kch;
  const int tx = threadIdx.x % TR, ty = threadIdx.x / TR;
  float* qq_s = smem + ST * C::FLOATS;
  float* sq_s = qq_s + C::TILEQ;
  float* m2_s = sq_s + ST * BIN_L;
  for (int t = threadIdx.x; t < C::TILEQ; t += C::THREADS)
    m2_s[t] = -CUDART_INF_F;
  auto load = [&](int c) {
    const int bin = b_begin + c / kch;
    load_chunk<C>(smem + (c % ST) * C::FLOATS, Q, X, B, N, D, q0,
                  bin * BIN_L, (c % kch) * KC);
    if ((FL & NORMS_SMEM) && c % kch == 0) {
      for (int t = threadIdx.x; t < BIN_L; t += C::THREADS) {
        const int r = bin * BIN_L + t;
        cp_async<1>(sq_s + (bin % ST) * BIN_L + t, r < N ? sq + r : sq,
                    r < N ? 4 : 0);
      }
    }
  };
  if (FL & NORMS_SMEM) {
    for (int t = threadIdx.x; t < C::TILEQ; t += C::THREADS) {
      const int qi = q0 + t;
      cp_async<1>(qq_s + t, qi < B ? qq + qi : qq, qi < B ? 4 : 0);
    }
  }
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  float acc[MQ][MR];
  float run_m2[MQ];
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    run_m2[i] = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < MR; ++j) acc[i][j] = 0.f;
  }
  int kc = 0, bin = b_begin;
  for (int c = 0; c < total; ++c) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (c + ST - 1 < total) load(c + ST - 1);
    cp_async_commit();
    const float* stage = smem + (c % ST) * C::FLOATS;
    const float* qs = stage + ty * C::LD;
    const float* xs = stage + (C::TILEQ + tx) * C::LD;
#pragma unroll UNR
    for (int k = 0; k < KC; k += 4) {
      if constexpr (MQ <= MR) {  // hold the queries, stream the rows
        float qf[MQ][4];
#pragma unroll
        for (int i = 0; i < MQ; ++i) {
          const float4 v =
              *reinterpret_cast<const float4*>(qs + i * TQ * C::LD + k);
          qf[i][0] = v.x, qf[i][1] = v.y, qf[i][2] = v.z, qf[i][3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < MR; ++j) {
          const float4 v =
              *reinterpret_cast<const float4*>(xs + j * TR * C::LD + k);
          const float xf[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
#pragma unroll
            for (int i = 0; i < MQ; ++i)
              acc[i][j] = __fmaf_rn(qf[i][cc], xf[cc], acc[i][j]);
        }
      } else {  // hold the rows, stream the queries
        float xf[MR][4];
#pragma unroll
        for (int j = 0; j < MR; ++j) {
          const float4 v =
              *reinterpret_cast<const float4*>(xs + j * TR * C::LD + k);
          xf[j][0] = v.x, xf[j][1] = v.y, xf[j][2] = v.z, xf[j][3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < MQ; ++i) {
          const float4 v =
              *reinterpret_cast<const float4*>(qs + i * TQ * C::LD + k);
          const float qf[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
#pragma unroll
            for (int j = 0; j < MR; ++j)
              acc[i][j] = __fmaf_rn(qf[cc], xf[j][cc], acc[i][j]);
        }
      }
    }
    if (++kc < kch) continue;
    kc = 0;
    if (FL & NO_EPILOGUE) {
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int j = 0; j < MR; ++j) t += acc[i][j], acc[i][j] = 0.f;
      if (tx == 0) sims[(size_t)(q0 + ty) * nbins + bin] = t;
      ++bin;
      continue;
    }
    const int r0 = bin * BIN_L;
    float sn[MR];
#pragma unroll
    for (int j = 0; j < MR; ++j) {
      const int r = r0 + tx + j * TR;
      sn[j] = r >= N                ? CUDART_INF_F
              : (FL & NORMS_SMEM) ? sq_s[(bin % ST) * BIN_L + tx + j * TR]
                                  : sq[r];
    }
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      const int qi = q0 + ty + i * TQ;
      const float qn = (FL & NORMS_SMEM) ? qq_s[ty + i * TQ]
                                         : (qi < B ? qq[qi] : 0.f);
      float a1 = -CUDART_INF_F, a2 = -CUDART_INF_F;
      int aj = 0;
#pragma unroll
      for (int j = 0; j < MR; ++j) {
        const float s =
            __fsub_rn(__fsub_rn(__fmul_rn(2.f, acc[i][j]), qn), sn[j]);
        if (j == 0 || s > a1) {
          a2 = a1, a1 = s, aj = j;
        } else {
          a2 = s > a2 ? s : a2;
        }
        acc[i][j] = 0.f;
      }
      const int idx = tx + aj * TR;
      float m1 = a1;
#pragma unroll
      for (int off = TR / 2; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, m1, off);
        m1 = o > m1 ? o : m1;
      }
      int win = a1 == m1 ? idx : BIN_L;
#pragma unroll
      for (int off = TR / 2; off > 0; off >>= 1)
        win = min(win, __shfl_xor_sync(0xffffffffu, win, off));
      float m2 = idx == win ? a2 : a1;
#pragma unroll
      for (int off = TR / 2; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, m2, off);
        m2 = o > m2 ? o : m2;
      }
      if (tx == 0 && qi < B) {
        sims[(size_t)qi * nbins + bin] = m1;
        ids[(size_t)qi * nbins + bin] = r0 + win;
      }
      if (!(FL & M2_SMEM)) {
        run_m2[i] = m2 > run_m2[i] ? m2 : run_m2[i];
      } else if (tx == 0) {
        float& run = m2_s[ty + i * TQ];
        run = m2 > run ? m2 : run;
      }
    }
    ++bin;
  }
  cp_async_wait<0>();
  if (FL & M2_SMEM) {
    __syncthreads();
    for (int t = threadIdx.x; t < C::TILEQ; t += C::THREADS)
      if (q0 + t < B) m2_part[(size_t)split * B + q0 + t] = m2_s[t];
  } else if (tx == 0) {
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      const int qi = q0 + ty + i * TQ;
      if (qi < B) m2_part[(size_t)split * B + qi] = run_m2[i];
    }
  }
}

int plan_splits(int slots, int q_tiles, int nbins) {  // ops/cuda_select.py
  int best = 1;
  long best_cost = -1;
  const int top = std::max(1, std::min({nbins, 4 * slots / q_tiles, 65535}));
  for (int s = 1; s <= top; ++s) {
    const long cost = (long)((q_tiles * s + slots - 1) / slots) *
                      ((nbins + s - 1) / s);
    if (best_cost < 0 || cost < best_cost) best = s, best_cost = cost;
  }
  return best;
}

struct Problem {
  int B, N, D, nbins;
  float *q, *x, *qq, *sq, *sims, *m2_part, *m2;
  int* ids;
  std::vector<unsigned> ref;  // the shipped kernel's outputs
};

std::vector<unsigned> outputs(const Problem& p) {
  const size_t n = (size_t)p.B * p.nbins;
  std::vector<unsigned> out(2 * n + p.B);
  CK(cudaMemcpy(out.data(), p.sims, n * 4, cudaMemcpyDeviceToHost));
  CK(cudaMemcpy(out.data() + n, p.ids, n * 4, cudaMemcpyDeviceToHost));
  CK(cudaMemcpy(out.data() + 2 * n, p.m2, p.B * 4, cudaMemcpyDeviceToHost));
  return out;
}

template <class F>
float time_ms(F&& launch) {
  launch();
  CK(cudaDeviceSynchronize());
  cudaEvent_t e0, e1;
  CK(cudaEventCreate(&e0));
  CK(cudaEventCreate(&e1));
  float best = 1e30f;
  for (int round = 0; round < 3; ++round) {
    CK(cudaEventRecord(e0));
    for (int r = 0; r < 5; ++r) launch();
    CK(cudaEventRecord(e1));
    CK(cudaEventSynchronize(e1));
    float ms;
    CK(cudaEventElapsedTime(&ms, e0, e1));
    best = std::min(best, ms / 5);
  }
  return best;
}

void report(const char* name, const cudaFuncAttributes& at, int per_sm,
            int splits, float ms, const char* verdict) {
  printf("%-46s regs %3d local %3zu B %d/SM %3d splits %8.3f ms  %s\n",
         name, at.numRegs, at.localSizeBytes, per_sm, splits, ms, verdict);
  fflush(stdout);
}

void run_shipped(Problem& p) {
  const int slots = select_bins_slots();
  const int splits = plan_splits(slots, (p.B + 127) / 128, p.nbins);
  cudaFuncAttributes at;
  CK(cudaFuncGetAttributes(&at, rht_select::select_bins_kernel<4>));
  const float ms = time_ms([&] {
    if (select_bins_launch(p.q, p.x, p.qq, p.sq, p.B, p.N, p.D, splits,
                           p.sims, p.ids, p.m2_part, p.m2, 0) != 0) {
      printf("select_bins_launch failed\n");
      exit(1);
    }
  });
  p.ref = outputs(p);
  int sms;
  CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  report("shipped select_bins.cu", at, slots / sms, splits, ms, "reference");
}

template <int TQ, int TR, int MQ, int MR, int MINB, int KC, int ST, int UNR,
          int FL>
void run(const char* name, Problem& p) {
  using C = V<TQ, TR, MQ, MR, MINB, KC, ST, UNR, FL>;
  auto k = kern<TQ, TR, MQ, MR, MINB, KC, ST, UNR, FL>;
  CK(cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                          C::SMEM));
  cudaFuncAttributes at;
  CK(cudaFuncGetAttributes(&at, k));
  int per_sm = 0, sms = 0;
  CK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, C::THREADS,
                                                   C::SMEM));
  CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  const int q_tiles = (p.B + C::TILEQ - 1) / C::TILEQ;
  const int splits = plan_splits(per_sm * sms, q_tiles, p.nbins);
  const int bps = (p.nbins + splits - 1) / splits;
  CK(cudaMemset(p.sims, 0, (size_t)p.B * p.nbins * 4));
  const float ms = time_ms([&] {
    k<<<dim3(q_tiles, splits), C::THREADS, C::SMEM>>>(
        p.q, p.x, p.qq, p.sq, p.B, p.N, p.D, p.nbins, bps, p.sims, p.ids,
        p.m2_part);
    rht_select::m2_reduce_kernel<<<(p.B + 255) / 256, 256>>>(
        p.m2_part, p.B, splits, p.m2);
  });
  const bool same = outputs(p) == p.ref;
  report(name, at, per_sm, splits, ms,
         (FL & NO_EPILOGUE) ? "timing only"
                            : (same ? "outputs equal" : "OUTPUTS DIFFER"));
}

}  // namespace study

int main() {
  using namespace study;
  Problem p;
  p.B = 2048, p.N = 1000064, p.D = 128, p.nbins = (p.N + BIN_L - 1) / BIN_L;
  std::vector<float> hq((size_t)p.B * p.D), hx((size_t)p.N * p.D);
  std::vector<float> hqq(p.B), hsq(p.N);
  uint64_t state = 12345;  // a fixed-seed LCG; sums of 3 uniforms
  auto uniform = [&] {
    state = state * 6364136223846793005ULL + 1442695040888963407ULL;
    return ((state >> 40) & 0xffffff) / 16777216.0f - 0.5f;
  };
  for (auto& v : hq) v = uniform() + uniform() + uniform();
  for (auto& v : hx) v = uniform() + uniform() + uniform();
  for (int b = 0; b < p.B; ++b)
    for (int d = 0; d < p.D; ++d)
      hqq[b] += hq[(size_t)b * p.D + d] * hq[(size_t)b * p.D + d];
  for (int n = 0; n < p.N; ++n)
    for (int d = 0; d < p.D; ++d)
      hsq[n] += hx[(size_t)n * p.D + d] * hx[(size_t)n * p.D + d];
  const size_t bins = (size_t)p.B * p.nbins;
  CK(cudaMalloc(&p.q, hq.size() * 4));
  CK(cudaMalloc(&p.x, hx.size() * 4));
  CK(cudaMalloc(&p.qq, p.B * 4));
  CK(cudaMalloc(&p.sq, p.N * 4));
  CK(cudaMalloc(&p.sims, bins * 4));
  CK(cudaMalloc(&p.ids, bins * 4));
  CK(cudaMalloc(&p.m2_part, (size_t)p.B * 65535 * 4));
  CK(cudaMalloc(&p.m2, p.B * 4));
  CK(cudaMemcpy(p.q, hq.data(), hq.size() * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(p.x, hx.data(), hx.size() * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(p.qq, hqq.data(), p.B * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(p.sq, hsq.data(), p.N * 4, cudaMemcpyHostToDevice));
  cudaDeviceProp prop;
  CK(cudaGetDeviceProperties(&prop, 0));
  printf("%s, B=%d N=%d D=%d\n", prop.name, p.B, p.N, p.D);

  run_shipped(p);
  run<16, 16, 8, 8, 2, 32, 3, 8, 0>(
      "8x8 tiles, 256 threads, norms from device", p);
  run<8, 16, 16, 8, 2, 32, 3, 8, 0>(
      "16x8 tiles (16 queries), 128 threads", p);
  run<16, 8, 8, 16, 2, 32, 3, 8, 0>(
      "8x16 tiles, 128 threads, norms from device", p);
  run<16, 8, 8, 16, 2, 32, 3, 8, NORMS_SMEM>(
      "8x16, norms in shared memory", p);
  run<16, 8, 8, 16, 2, 32, 3, 8, NORMS_SMEM | M2_SMEM>(
      "8x16, norms and m2 in smem", p);
  run<16, 8, 8, 16, 2, 32, 3, 2, NORMS_SMEM | M2_SMEM>(
      "8x16, norms and m2 in smem, dims unrolled by 2", p);
  run<16, 8, 8, 16, 2, 16, 4, 2, NORMS_SMEM | M2_SMEM>(
      "same, 16-dim chunks, 4 stages", p);
  run<32, 8, 8, 16, 1, 32, 3, 2, NORMS_SMEM | M2_SMEM>(
      "same, 256-query tiles, 256 threads", p);
  run<16, 8, 8, 16, 2, 32, 3, 2, NORMS_SMEM | M2_SMEM | NO_EPILOGUE>(
      "same (128 queries), no bin reduction", p);
  run_shipped(p);
  return 0;
}
