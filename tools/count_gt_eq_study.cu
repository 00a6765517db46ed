// Design study of kernel B (redis_hnsw_tpu_torch/csrc/count_gt_eq.cu):
// the shipped kernel -- each query's 16 scores a thread tested against
// its threshold with one compare each (s >= t), counted only when a lane
// of the warp has a hit, into per-query counters in shared memory --
// beside the same counters filled on every tile without the vote, beside
// 16 counts a thread held in registers across the FMA loop (every tile),
// and beside the FMA loop alone (no count epilogue: the accumulators run
// on across tiles and are written once; timing only). Timed at the main
// path's shapes (B = 2048 and B = 16 over N = 1,000,064 rows, and 2048 x
// 16,384; D = 128) on synthetic data where, as in the certificate, few
// rows reach a query's threshold (row 3b is a copy of query b, and t[b]
// its score); the other forms' counts are compared with the shipped
// kernel's.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -Xptxas -v -o /tmp/count_gt_eq_study tools/count_gt_eq_study.cu
//   /tmp/count_gt_eq_study
//
// One line per form and shape: registers, local memory (spills),
// resident blocks per SM, splits, ms per launch (best of 3 runs of 5
// launches, CUDA events) and whether the counts equal the shipped
// kernel's.

#include "../redis_hnsw_tpu_torch/csrc/count_gt_eq.cu"

#include <algorithm>
#include <cstdio>
#include <cstdlib>
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

using namespace rht_l2;

constexpr int REGS = 0, LOOP_ONLY = 1, ALWAYS = 2;

// The shipped kernel's loop; MODE REGS keeps gt[i] / eq[i] of the
// thread's 8 queries in registers and reduces them once, at the block's
// end; MODE ALWAYS is the shipped epilogue without its vote on s >= t;
// MODE LOOP_ONLY has no epilogue.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
    variant(const float* __restrict__ Q, const float* __restrict__ X,
            const float* __restrict__ qq, const float* __restrict__ sq,
            const float* __restrict__ thr, int B, int N, int D, int ntiles,
            int tiles_per_split, int* __restrict__ c_gt,
            int* __restrict__ c_eq) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * TILE_Q;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  const int kch = max(1, (D + K_CHUNK - 1) / K_CHUNK);
  const int total = max(0, t_end - t_begin) * kch;
  const int tx = threadIdx.x % TR;
  const int ty = threadIdx.x / TR;
  float* const qq_s = smem + STAGES * STAGE_FLOATS;
  float* const sq_s = qq_s + TILE_Q;
  float* const th_s = sq_s + STAGES * TILE_R;
  if (MODE == ALWAYS) {
    reinterpret_cast<int*>(th_s + TILE_Q)[threadIdx.x] = 0;
    reinterpret_cast<int*>(th_s + TILE_Q)[TILE_Q + threadIdx.x] = 0;
  }
  auto load = [&](int c) {
    const int t = t_begin + c / kch;
    const int part = c % kch;
    load_chunk<4>(smem + (c % STAGES) * STAGE_FLOATS, Q, X, B, N, D, q0,
                  t * TILE_R, part * K_CHUNK);
    if (part == 0) {
      const int r = t * TILE_R + threadIdx.x;
      cp_async<1>(sq_s + (t % STAGES) * TILE_R + threadIdx.x,
                  r < N ? sq + r : sq, r < N ? 4 : 0);
    }
  };
  {
    const int qi = q0 + threadIdx.x;
    cp_async<1>(qq_s + threadIdx.x, qi < B ? qq + qi : qq, qi < B ? 4 : 0);
    cp_async<1>(th_s + threadIdx.x, qi < B ? thr + qi : thr, qi < B ? 4 : 0);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  float acc[MQ][MR];
  int gt[MQ], eq[MQ];
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    gt[i] = eq[i] = 0;
#pragma unroll
    for (int j = 0; j < MR; ++j) acc[i][j] = 0.f;
  }
  int kc = 0;
  int t = t_begin;
  for (int c = 0; c < total; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (c + STAGES - 1 < total) load(c + STAGES - 1);
    cp_async_commit();
    fma_chunk(smem + (c % STAGES) * STAGE_FLOATS, tx, ty, acc);
    if (++kc < kch) continue;
    kc = 0;
    if (MODE == LOOP_ONLY) {
      ++t;
      continue;
    }
    const int r0 = t * TILE_R;
    const float* const sq_t = sq_s + (t % STAGES) * TILE_R;
    float sn[MR];
#pragma unroll
    for (int j = 0; j < MR; ++j) {
      const int r = tx + j * TR;
      sn[j] = r0 + r < N ? sq_t[r] : CUDART_NAN_F;
    }
    if (MODE == ALWAYS) {
      int* const gt_s = reinterpret_cast<int*>(th_s + TILE_Q);
      int* const eq_s = gt_s + TILE_Q;
#pragma unroll
      for (int i = 0; i < MQ; ++i) {
        const int ql = ty + i * TQ;
        const float qn = qq_s[ql];
        const float th = th_s[ql];
        int n = 0;
#pragma unroll
        for (int j = 0; j < MR; ++j) {
          const float s = l2_score(acc[i][j], qn, sn[j]);
          acc[i][j] = 0.f;
          n += (s > th) + ((s == th) << 16);
        }
#pragma unroll
        for (int off = TR / 2; off > 0; off >>= 1) {
          n += __shfl_xor_sync(FULL_MASK, n, off);
        }
        if (tx == 0) {
          gt_s[ql] += n & 0xffff;
          eq_s[ql] += n >> 16;
        }
      }
      ++t;
      continue;
    }
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      const int ql = ty + i * TQ;
      const float qn = qq_s[ql];
      const float th = th_s[ql];
#pragma unroll
      for (int j = 0; j < MR; ++j) {
        const float s = l2_score(acc[i][j], qn, sn[j]);
        acc[i][j] = 0.f;
        gt[i] += s > th;
        eq[i] += s == th;
      }
    }
    ++t;
  }
  cp_async_wait<0>();
  if (MODE == LOOP_ONLY) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int j = 0; j < MR; ++j) sum += acc[i][j];
    if (sum == 1.2345f) c_gt[0] = 1;  // keeps the loop alive
    return;
  }
  if (MODE == ALWAYS) {
    __syncthreads();
    const int* const gt_s = reinterpret_cast<const int*>(th_s + TILE_Q);
    const int qi = q0 + threadIdx.x;
    if (qi < B) {
      if (gt_s[threadIdx.x]) atomicAdd(&c_gt[qi], gt_s[threadIdx.x]);
      if (gt_s[TILE_Q + threadIdx.x]) {
        atomicAdd(&c_eq[qi], gt_s[TILE_Q + threadIdx.x]);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
#pragma unroll
    for (int off = TR / 2; off > 0; off >>= 1) {
      gt[i] += __shfl_xor_sync(FULL_MASK, gt[i], off);
      eq[i] += __shfl_xor_sync(FULL_MASK, eq[i], off);
    }
    const int qi = q0 + ty + i * TQ;
    if (tx == 0 && qi < B) {
      if (gt[i]) atomicAdd(&c_gt[qi], gt[i]);
      if (eq[i]) atomicAdd(&c_eq[qi], eq[i]);
    }
  }
}

// ops/cuda_select.py plan_splits with no fixed work a split
int plan_splits(int slots, int q_tiles, int tiles) {
  int best = 1;
  long best_cost = -1;
  const int top = std::max(1, std::min({tiles, 4 * slots / q_tiles, 65535}));
  for (int s = 1; s <= top; ++s) {
    const long cost = (long)((q_tiles * s + slots - 1) / slots) *
                      ((tiles + s - 1) / s);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

struct Problem {
  int B, N, D;
  const float *q, *x, *qq, *sq, *t;
  int *gt, *eq;
};

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

std::vector<int> counts(const Problem& p) {
  std::vector<int> out(2 * p.B);
  CK(cudaMemcpy(out.data(), p.gt, p.B * 4, cudaMemcpyDeviceToHost));
  CK(cudaMemcpy(out.data() + p.B, p.eq, p.B * 4, cudaMemcpyDeviceToHost));
  return out;
}

void zero(const Problem& p) {
  CK(cudaMemsetAsync(p.gt, 0, p.B * 4));
  CK(cudaMemsetAsync(p.eq, 0, p.B * 4));
}

void report(const char* name, const Problem& p, const void* kernel,
            int per_sm, int splits, float ms, const char* verdict) {
  cudaFuncAttributes at;
  CK(cudaFuncGetAttributes(&at, kernel));
  printf("%-34s B=%4d N=%7d: regs %3d local %3zu B %d/SM %3d splits "
         "%8.4f ms  %s\n",
         name, p.B, p.N, at.numRegs, at.localSizeBytes, per_sm, splits, ms,
         verdict);
  fflush(stdout);
}

std::vector<int> run_shipped(const Problem& p) {
  using namespace rht_count;
  const int slots = count_gt_eq_slots();
  const int ntiles = (p.N + TILE_R - 1) / TILE_R;
  const int splits = plan_splits(slots, (p.B + TILE_Q - 1) / TILE_Q, ntiles);
  const float ms = time_ms([&] {
    zero(p);
    if (count_gt_eq_launch(p.q, p.x, p.qq, p.sq, p.t, p.B, p.N, p.D, splits,
                           p.gt, p.eq, 0) != 0) {
      printf("count_gt_eq_launch failed\n");
      exit(1);
    }
  });
  int sms;
  CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  report("shipped (vote on s >= t)", p, (const void*)count_kernel<4>,
         slots / sms, splits, ms, "reference");
  return counts(p);
}

template <int MODE>
void run(const char* name, const Problem& p, const std::vector<int>& ref) {
  auto k = variant<MODE>;
  const int smem = rht_count::SMEM_BYTES;
  CK(cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                          smem));
  int per_sm = 0, sms = 0;
  CK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS,
                                                   smem));
  CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  const int q_tiles = (p.B + TILE_Q - 1) / TILE_Q;
  const int ntiles = (p.N + TILE_R - 1) / TILE_R;
  const int splits = plan_splits(per_sm * sms, q_tiles, ntiles);
  const int tps = (ntiles + splits - 1) / splits;
  const float ms = time_ms([&] {
    zero(p);
    k<<<dim3(q_tiles, splits), THREADS, smem>>>(p.q, p.x, p.qq, p.sq, p.t,
                                                 p.B, p.N, p.D, ntiles, tps,
                                                 p.gt, p.eq);
  });
  CK(cudaGetLastError());
  const char* verdict = MODE == LOOP_ONLY      ? "timing only"
                        : counts(p) == ref ? "counts equal"
                                           : "COUNTS DIFFER";
  report(name, p, (const void*)k, per_sm, splits, ms, verdict);
}

}  // namespace study

int main() {
  using namespace study;
  const int BMAX = 2048, NMAX = 1000064, D = 128;
  std::vector<float> hq((size_t)BMAX * D), hx((size_t)NMAX * D);
  std::vector<float> hqq(BMAX), hsq(NMAX), ht(BMAX);
  uint64_t state = 12345;  // a fixed-seed LCG; sums of 3 uniforms
  auto uniform = [&] {
    state = state * 6364136223846793005ULL + 1442695040888963407ULL;
    return ((state >> 40) & 0xffffff) / 16777216.0f - 0.5f;
  };
  for (auto& v : hq) v = uniform() + uniform() + uniform();
  for (auto& v : hx) v = uniform() + uniform() + uniform();
  for (int b = 0; b < BMAX; ++b)
    for (int d = 0; d < D; ++d)
      hqq[b] += hq[(size_t)b * D + d] * hq[(size_t)b * D + d];
  for (int n = 0; n < NMAX; ++n)
    for (int d = 0; d < D; ++d)
      hsq[n] += hx[(size_t)n * D + d] * hx[(size_t)n * D + d];
  // each query's threshold: its score against row 3b, a copy of it (host
  // rounding): few rows reach it, as in the certificate
  for (int b = 0; b < BMAX; ++b) {
    for (int d = 0; d < D; ++d) hx[(size_t)3 * b * D + d] = hq[(size_t)b * D + d];
    hsq[3 * b] = hqq[b];
  }
  for (int b = 0; b < BMAX; ++b) {
    float dot = 0.f;
    for (int d = 0; d < D; ++d)
      dot += hq[(size_t)b * D + d] * hx[(size_t)3 * b * D + d];
    ht[b] = 2.f * dot - hqq[b] - hsq[3 * b];
  }
  float *q, *x, *qq, *sq, *t;
  int *gt, *eq;
  CK(cudaMalloc(&q, hq.size() * 4));
  CK(cudaMalloc(&x, hx.size() * 4));
  CK(cudaMalloc(&qq, BMAX * 4));
  CK(cudaMalloc(&sq, NMAX * 4));
  CK(cudaMalloc(&t, BMAX * 4));
  CK(cudaMalloc(&gt, BMAX * 4));
  CK(cudaMalloc(&eq, BMAX * 4));
  CK(cudaMemcpy(q, hq.data(), hq.size() * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(x, hx.data(), hx.size() * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(qq, hqq.data(), BMAX * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(sq, hsq.data(), NMAX * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(t, ht.data(), BMAX * 4, cudaMemcpyHostToDevice));
  cudaDeviceProp prop;
  CK(cudaGetDeviceProperties(&prop, 0));
  printf("%s, D=%d\n", prop.name, D);

  const int shapes[3][2] = {{2048, NMAX}, {16, NMAX}, {2048, 16384}};
  for (const auto& s : shapes) {
    const Problem p{s[0], s[1], D, q, x, qq, sq, t, gt, eq};
    const std::vector<int> ref = run_shipped(p);
    run<REGS>("16 counts a thread in registers", p, ref);
    run<ALWAYS>("the same counters, every tile", p, ref);
    run<LOOP_ONLY>("the FMA loop alone", p, ref);
    run_shipped(p);
  }
  return 0;
}
