// Design study of kernel A-bf16, the bf16 scan tier's select: its wgmma
// form (redis_hnsw_tpu_torch/csrc/scan_bf16.cu, warpgroup MMA on TMA-fed
// tiles) beside its general form (csrc/scan_lowp.cu
// lowp_tile_kernel<Bf16Core>, mma.sync on a cp.async ring), at the main
// path's shape, B = 2048 queries over 1,000,064 x 128 bf16 rows, k = 10
// and 80. The rows are seeded Gaussian values rounded to multiples of
// 1/16 (|v| <= 8): exact in bf16, with every product and partial sum
// exact in f32, so the two forms' outputs must agree byte for byte while
// the scores stay as spread as Gaussian ones.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o /tmp/bf16_core_study tools/bf16_core_study.cu
//   /tmp/bf16_core_study
//
// (-DRHT_BF16_CWG=3: three consumer warpgroups, 192 queries a block;
// -DRHT_BF16_STAGES=n: a ring of n stages.)
// Prints each form's registers, local memory (spills) and resident blocks;
// its ms per launch (best of 3 runs of 5 launches, CUDA events) and
// whether its outputs equal the general form's byte for byte; the wgmma
// form's MMAs and copies alone (no scores: timing only); its selection's
// knobs (DRAIN_AT, REFRESH); and, from an instrumented copy (its outputs
// compared too), where a consumer warp's cycles go: copy wait, MMA, the
// exact score of every row with its vote, admission, drain, the last
// drain and heap sort -- then list_merge_kernel's time alone.

#include "../redis_hnsw_tpu_torch/csrc/scan_bf16.cu"
#include "../redis_hnsw_tpu_torch/csrc/scan_lowp.cu"

#include <cuda_bf16.h>

#include <algorithm>
#include <cmath>
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

using rht_lowp::Bf16Core;

// -- seeded operands, made on the card --------------------------------------

__device__ __forceinline__ uint32_t mix(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return (uint32_t)x;
}

// Row r of a [rows, D] table: Gaussian values (Box-Muller on two hashed
// uniforms) rounded to multiples of 1/16 within [-8, 8], as bf16; sqn =
// sum v^2 in f32 (exact). One warp a row, D <= 256.
__global__ void make_rows(int rows, int D, uint64_t seed, __nv_bfloat16* q,
                          float* sqn) {
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = lane + 32 * i;
    if (d >= D) continue;
    const uint64_t e =
        ((uint64_t)r * D + d) * 2 + seed * 0x9e3779b97f4a7c15ULL;
    const float u1 = (mix(e) + 1.f) * 2.3283064e-10f;
    const float u2 = mix(e + 1) * 2.3283064e-10f;
    const float g = sqrtf(-2.f * logf(u1)) * cospif(2.f * u2);
    const float v = fminf(8.f, fmaxf(-8.f, rintf(g * 16.f) * 0.0625f));
    q[(size_t)r * D + d] = __float2bfloat16_rn(v);
    s += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) sqn[r] = s;
}

// Table edits: row b copied onto row a (a tie class), every 997th row dead
// (sq = +inf).
__global__ void edit_rows(int N, int D, __nv_bfloat16* x, float* sq, int a,
                          int b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < D) x[(size_t)a * D + i] = x[(size_t)b * D + i];
  if (i == 0) sq[a] = sq[b];
  if ((long long)i * 997 < N) sq[(size_t)i * 997] = INFINITY;
}

struct Problem {
  int B, N, D, k;
  __nv_bfloat16* q;
  __nv_bfloat16* x;
  float *qq, *sq;
  int2* slabs;
  unsigned* kshare;  // the wgmma form's shared k-th best, [B]
  float* out_s;
  int* out_i;
};

// ops/cuda_select.py plan_splits with ops/cuda_scan.py's
// HAMMING_SPLIT_TILES, as ops/cuda_scan.py lowp_plan calls it for the
// general form
constexpr int SPLIT_TILES = 96;
int plan_splits(int slots, int q_tiles, int ntiles) {
  int best = 1;
  long long best_cost = -1;
  const int hi = std::max(1, std::min(ntiles, std::min(4 * slots / q_tiles,
                                                       65535)));
  for (int s = 1; s <= hi; ++s) {
    const long long cost =
        (long long)((q_tiles * (long long)s + slots - 1) / slots) *
        ((ntiles + s - 1) / s + SPLIT_TILES);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// ops/cuda_scan.py wave_plan
int wave_splits(int slots, int B, int N) {
  const int tiles = std::max(1, (N + 127) / 128);
  const int q_tiles =
      std::max(1, (B + rht_bf16::TILE_Q - 1) / rht_bf16::TILE_Q);
  const int s = std::max(1, std::min(std::min(slots / q_tiles, tiles), 65535));
  const int per = (tiles + s - 1) / s;
  return (tiles + per - 1) / per;
}

template <class F>
float best_ms(F launch) {
  launch();
  CK(cudaDeviceSynchronize());
  cudaEvent_t e0, e1;
  CK(cudaEventCreate(&e0));
  CK(cudaEventCreate(&e1));
  float best = 1e30f;
  for (int r = 0; r < 3; ++r) {
    CK(cudaEventRecord(e0));
    for (int i = 0; i < 5; ++i) launch();
    CK(cudaEventRecord(e1));
    CK(cudaEventSynchronize(e1));
    float ms = 0;
    CK(cudaEventElapsedTime(&ms, e0, e1));
    best = std::min(best, ms / 5);
  }
  CK(cudaEventDestroy(e0));
  CK(cudaEventDestroy(e1));
  return best;
}

struct Outputs {
  std::vector<float> s;
  std::vector<int> i;
  void read(const Problem& p) {
    s.resize((size_t)p.B * p.k);
    i.resize((size_t)p.B * p.k);
    CK(cudaMemcpy(s.data(), p.out_s, s.size() * 4, cudaMemcpyDeviceToHost));
    CK(cudaMemcpy(i.data(), p.out_i, i.size() * 4, cudaMemcpyDeviceToHost));
  }
  bool operator==(const Outputs& o) const {
    return i == o.i && s.size() == o.s.size() &&
           memcmp(s.data(), o.s.data(), s.size() * 4) == 0;
  }
};

// -- the general form ---------------------------------------------------------

int general_splits(const Problem& p) {
  return plan_splits(rht_lowp::slots<Bf16Core>(), (p.B + 127) / 128,
                     (p.N + 127) / 128);
}

float run_general(const Problem& p, int splits) {
  return best_ms([&] {
    CK((cudaError_t)rht_lowp::launch<Bf16Core>(
        reinterpret_cast<const unsigned char*>(p.q),
        reinterpret_cast<const unsigned char*>(p.x), p.qq, nullptr, p.sq,
        nullptr, p.B, p.N, 2 * p.D, p.k, splits, p.slabs, p.out_s, p.out_i,
        0));
  });
}

// The merge over the slabs a split kernel left: ms per launch.
float merge_ms(const Problem& p, int splits) {
  const int slab_len = rht_scan::heap_len(p.k) + rht_scan::BUF_CAP;
  return best_ms([&] {
    CK((cudaError_t)rht_scan::launch_merge(p.slabs, slab_len, p.B, p.k,
                                           splits, p.out_s, p.out_i, 0));
  });
}

void general_figures() {
  cudaFuncAttributes a;
  CK(cudaFuncGetAttributes(&a, rht_lowp::lowp_tile_kernel<Bf16Core, 16>));
  printf("general form lowp_tile_kernel<Bf16Core, 16>: %d registers, %zu "
         "bytes local, %d bytes of dynamic shared memory, %d blocks per SM\n",
         a.numRegs, a.localSizeBytes, rht_lowp::SMEM_BYTES,
         rht_lowp::blocks_per_sm<Bf16Core, 16>());
}

// -- the wgmma form -------------------------------------------------------

// The wgmma form's cycle counters: a consumer warp's phases 0..7 and the
// producer's 8, 9 (rht_bf16's P_* names), summed over warps by lane 0.
const char* const WPHASE_NAMES[rht_bf16::PHASES] = {
    "set-up", "copy wait", "rows' sq", "mma (issue + wait)",
    "drain (vote, drains)", "score epilogue (every row's exact score, max, "
    "vote)", "admission (scores again, appends)", "last drain + heap sort",
    "producer: stage wait", "producer: issue"};
__device__ unsigned long long g_wcycles[rht_bf16::PHASES];
__device__ unsigned long long g_wcounts[rht_bf16::COUNTS];

struct CycleProbe {
  static constexpr bool COUNTING = true;
  unsigned long long cyc[rht_bf16::PHASES];
  unsigned long long cnt[rht_bf16::COUNTS];
  long long t;
  __device__ void start() {
    for (int i = 0; i < rht_bf16::PHASES; ++i) cyc[i] = 0;
    for (int i = 0; i < rht_bf16::COUNTS; ++i) cnt[i] = 0;
    t = clock64();
  }
  __device__ void count(int i, int n) { cnt[i] += n; }
  __device__ void mark(int i) {
    const long long n = clock64();
    cyc[i] += n - t;
    t = n;
  }
  __device__ void finish() {
    if (threadIdx.x % 32 == 0) {
      for (int i = 0; i < rht_bf16::PHASES; ++i) {
        if (cyc[i]) atomicAdd(&g_wcycles[i], cyc[i]);
      }
    }
    for (int i = 0; i < rht_bf16::COUNTS; ++i) {
      if (cnt[i]) atomicAdd(&g_wcounts[i], cnt[i]);
    }
  }
};

template <class Probe, class Tune = rht_bf16::Tuning>
int launch_wgmma(const Problem& p, int splits) {
  return rht_bf16::launch_form<Probe, Tune>(
      reinterpret_cast<const unsigned char*>(p.q),
      reinterpret_cast<const unsigned char*>(p.x), p.qq, p.sq, p.B, p.N,
      2 * p.D, p.k, splits, p.slabs, p.kshare, p.out_s, p.out_i, 0);
}

template <class Probe, class Tune = rht_bf16::Tuning>
float run_wgmma(const Problem& p, int splits) {
  return best_ms(
      [&] { CK(((cudaError_t)launch_wgmma<Probe, Tune>(p, splits))); });
}

// Other settings of the selection's knobs (scan_bf16.cu Tuning).
template <int D, int R, bool S = true>
struct Knobs {
  static constexpr int DRAIN_AT = D;
  static constexpr int REFRESH = R;
  static constexpr bool SCORES = S;
};

void wgmma_figures() {
  cudaFuncAttributes a;
  CK(cudaFuncGetAttributes(
      &a, rht_bf16::bf16_tile_kernel<rht_bf16::NoProbe>));
  printf("wgmma form bf16_tile_kernel: %d registers, %zu bytes local, %d "
         "bytes of dynamic shared memory at 256-byte rows, %d blocks per SM; "
         "%d consumer warpgroups, %d queries a block, %d ring stages\n",
         a.numRegs, a.localSizeBytes, rht_bf16::smem_bytes(256),
         rht_bf16::blocks_per_sm<rht_bf16::NoProbe>(256), rht_bf16::CWG,
         rht_bf16::TILE_Q, rht_bf16::STAGES);
}

// One launch of the instrumented wgmma form: each phase's cycles a
// consumer warp (averaged over the consumer warps of every block) and the
// producer's issuing lane's; its outputs against `want`.
void wgmma_phases(const Problem& p, int splits, const Outputs& want) {
  const int blocks =
      ((p.B + rht_bf16::TILE_Q - 1) / rht_bf16::TILE_Q) * splits;
  unsigned long long zero[rht_bf16::PHASES] = {};
  CK(cudaMemcpyToSymbol(g_wcycles, zero, sizeof(zero)));
  unsigned long long zc[rht_bf16::COUNTS] = {};
  CK(cudaMemcpyToSymbol(g_wcounts, zc, sizeof(zc)));
  CK((cudaError_t)launch_wgmma<CycleProbe>(p, splits));
  CK(cudaDeviceSynchronize());
  Outputs got;
  got.read(p);
  unsigned long long cyc[rht_bf16::PHASES], cnt[rht_bf16::COUNTS];
  CK(cudaMemcpyFromSymbol(cyc, g_wcycles, sizeof(cyc)));
  CK(cudaMemcpyFromSymbol(cnt, g_wcounts, sizeof(cnt)));
  double sum = 0;
  const double cw = 4.0 * rht_bf16::CWG * blocks;  // consumer warps
  for (int i = 0; i < rht_bf16::P_EMPTY_WAIT; ++i) sum += cyc[i] / cw;
  printf("wgmma form, instrumented, B=%d N=%d k=%d (%s the general form's "
         "outputs), cycles a consumer warp by phase:",
         p.B, p.N, p.k, got == want ? "equal to" : "DIFFERENT from");
  for (int i = 0; i < rht_bf16::P_EMPTY_WAIT; ++i) {
    printf(" %s %.0f (%.1f%%);", WPHASE_NAMES[i], cyc[i] / cw,
           100.0 * cyc[i] / cw / sum);
  }
  const double pairs = (double)p.B * p.N;
  printf(" total %.0f; the producer warp: %s %.0f, %s %.0f; warp epilogues "
         "%llu, %.2f%% of them on the admission path; rows admitted %.3g a "
         "(query, row); list_merge_kernel alone %.4f ms\n",
         sum, WPHASE_NAMES[rht_bf16::P_EMPTY_WAIT],
         cyc[rht_bf16::P_EMPTY_WAIT] / (double)blocks,
         WPHASE_NAMES[rht_bf16::P_ISSUE],
         cyc[rht_bf16::P_ISSUE] / (double)blocks, cnt[rht_bf16::C_EPILOGUES],
         100.0 * cnt[rht_bf16::C_SLOW] / cnt[rht_bf16::C_EPILOGUES],
         cnt[rht_bf16::C_ADMITTED] / pairs, merge_ms(p, splits));
}

}  // namespace study

int main() {
  using namespace study;
  const int B = 2048, N = 1000064, D = 128;
  Problem p{};
  p.B = B;
  p.N = N;
  p.D = D;
  CK(cudaMalloc(&p.q, (size_t)B * D * 2));
  CK(cudaMalloc(&p.x, (size_t)N * D * 2));
  CK(cudaMalloc(&p.qq, B * 4));
  CK(cudaMalloc(&p.sq, (size_t)N * 4));
  make_rows<<<(B + 7) / 8, 256>>>(B, D, 1, p.q, p.qq);
  make_rows<<<(N + 7) / 8, 256>>>(N, D, 2, p.x, p.sq);
  edit_rows<<<(N / 997 + 256) / 256, 256>>>(N, D, p.x, p.sq, N / 2, N / 3);
  CK(cudaGetLastError());
  CK(cudaDeviceSynchronize());
  const int kmax = 80;
  const size_t slab_bytes =
      (size_t)200 * B * (rht_scan::heap_len(kmax) + rht_scan::BUF_CAP) * 8;
  CK(cudaMalloc(&p.slabs, slab_bytes));
  CK(cudaMalloc(&p.kshare, (size_t)B * 4));
  CK(cudaMalloc(&p.out_s, (size_t)B * kmax * 4));
  CK(cudaMalloc(&p.out_i, (size_t)B * kmax * 4));
  cudaDeviceProp prop;
  CK(cudaGetDeviceProperties(&prop, 0));
  printf("%s, %d SMs; B=%d N=%d D=%d bf16 (Gaussian on a 1/16 lattice)\n",
         prop.name, prop.multiProcessorCount, B, N, D);
  general_figures();
  wgmma_figures();
  const int ws = wave_splits(
      rht_bf16::blocks_per_sm<rht_bf16::NoProbe>(256) *
          prop.multiProcessorCount,
      B, N);
  for (int k : {10, 80}) {
    p.k = k;
    const int gs = general_splits(p);
    const float ms = run_general(p, gs);
    Outputs want;
    want.read(p);
    printf("B=%d N=%d k=%d general form: %d splits, %.4f ms; query 0 top-2 "
           "ids %d %d sims %.9g %.9g\n",
           B, N, k, gs, ms, want.i[0], want.i[1], want.s[0], want.s[1]);
    const float w = run_wgmma<rht_bf16::NoProbe>(p, ws);
    Outputs got;
    got.read(p);
    printf("B=%d N=%d k=%d wgmma form: %d splits, %.4f ms (%s); general / "
           "wgmma %.2fx\n",
           B, N, k, ws, w, got == want ? "equal" : "DIFFERENT", ms / w);
    // the knobs, each run's outputs against the general form's
    printf("B=%d N=%d k=%d wgmma form by (DRAIN_AT, REFRESH) (shipped: (%d, "
           "%d)):",
           B, N, k, rht_bf16::Tuning::DRAIN_AT, rht_bf16::Tuning::REFRESH);
    auto knob = [&](auto tune, int d, int r) {
      const float ms =
          run_wgmma<rht_bf16::NoProbe, decltype(tune)>(p, ws);
      Outputs got;
      got.read(p);
      printf(" (%d, %d) %.4f ms%s;", d, r, ms,
             got == want ? "" : " DIFFERENT");
    };
    knob(Knobs<16, 16>{}, 16, 16);
    knob(Knobs<48, 64>{}, 48, 64);
    knob(Knobs<112, 64>{}, 112, 64);
    printf("\n");
    printf("B=%d N=%d k=%d wgmma form, MMAs and copies alone (no scores, "
           "timing only): %.4f ms\n", B, N, k,
           run_wgmma<rht_bf16::NoProbe, Knobs<16, 64, false>>(p, ws));
    wgmma_phases(p, ws, want);
  }
  return 0;
}
