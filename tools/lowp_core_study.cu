// Design study of kernel A-int8, the int8 scan tier's select: its wgmma
// form (redis_hnsw_tpu_torch/csrc/scan_int8.cu, warpgroup MMA on TMA-fed
// tiles) beside its general form (csrc/scan_lowp.cu
// lowp_tile_kernel<Int8Core>, mma.sync on a cp.async ring), at the main
// path's shape, B = 2048 queries over 1,000,064 x 128 int8 rows, k = 10
// and 80, on seeded Gaussian rows quantized per row as the tier does
// (scale = max|v| / 127).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o /tmp/lowp_core_study tools/lowp_core_study.cu
//   /tmp/lowp_core_study
//
// Prints each form's registers, local memory (spills) and resident blocks;
// its ms per launch (best of 3 runs of 5 launches, CUDA events) and
// whether its outputs equal the general form's byte for byte; the wgmma
// form's two epilogues priced against each other -- (a) the exact score
// of every row, (b) the shipped filter, one add-max a score against a
// bound split into a query term and a row term;
// and, from instrumented copies (their outputs compared too), where a
// block's cycles go: copy wait, MMA, score epilogue, admission, drain,
// the last drain and heap sort, then list_merge_kernel's time alone.

#include "../redis_hnsw_tpu_torch/csrc/scan_int8.cu"
#include "../redis_hnsw_tpu_torch/csrc/scan_lowp.cu"

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

using rht_lowp::Int8Core;

// -- seeded operands, made on the card --------------------------------------

__device__ __forceinline__ uint32_t mix(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return (uint32_t)x;
}

// Row r of a [rows, D] Gaussian table (Box-Muller on two hashed uniforms),
// quantized per row: scale = max|v| / 127 (1 on a zero row), q = rint(v /
// scale); sqn = sum v^2 in f32. One warp a row, D <= 256.
__global__ void make_rows(int rows, int D, uint64_t seed, signed char* q,
                          float* scale, float* sqn) {
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  float v[8];
  float m = 0.f, s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = lane + 32 * i;
    v[i] = 0.f;
    if (d < D) {
      const uint64_t e =
          ((uint64_t)r * D + d) * 2 + seed * 0x9e3779b97f4a7c15ULL;
      const float u1 = (mix(e) + 1.f) * 2.3283064e-10f;
      const float u2 = mix(e + 1) * 2.3283064e-10f;
      v[i] = sqrtf(-2.f * logf(u1)) * cospif(2.f * u2);
    }
    m = fmaxf(m, fabsf(v[i]));
    s = fmaf(v[i], v[i], s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    s += __shfl_xor_sync(0xffffffffu, s, o);
  }
  const float sc = m > 0.f ? m * (1.f / 127.f) : 1.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = lane + 32 * i;
    if (d < D) {
      q[(size_t)r * D + d] =
          (signed char)fminf(127.f, fmaxf(-127.f, rintf(v[i] / sc)));
    }
  }
  if (lane == 0) {
    scale[r] = sc;
    sqn[r] = s;
  }
}

// Table edits: row b copied onto row a (a tie class), every 997th row dead
// (sq = +inf).
__global__ void edit_rows(int N, int D, signed char* x, float* ts, float* sq,
                          int a, int b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < D) x[(size_t)a * D + i] = x[(size_t)b * D + i];
  if (i == 0) {
    ts[a] = ts[b];
    sq[a] = sq[b];
  }
  if ((long long)i * 997 < N) sq[(size_t)i * 997] = INFINITY;
}

struct Problem {
  int B, N, D, k;
  signed char* q;
  signed char* x;
  float *qq, *qs, *sq, *ts;
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

// -- the general form, instrumented -----------------------------------------

// Where a block's time goes: a copy of the shipped lowp_tile_kernel<Int8Core,
// 16> (and of its admit) whose warps read clock64() around each part of a
// tile and add the cycles to counters; and counts of drains and appends.
// Timing only: the clock reads cost a little themselves.
constexpr int GPHASES = 7;
const char* const GPHASE_NAMES[GPHASES] = {
    "set-up", "copy wait + barrier", "mma (ldmatrix + mma.sync)",
    "score epilogue (score, compare, vote)", "admission (prefix, atomics, "
    "appends)", "drain (vote + drains)", "last drain + heap sort"};
__device__ unsigned long long g_cycles[GPHASES];
__device__ unsigned long long g_drains, g_appends;

struct Clock {
  unsigned long long cyc[GPHASES];
  long long t;
  __device__ void start() {
    for (int i = 0; i < GPHASES; ++i) cyc[i] = 0;
    t = clock64();
  }
  __device__ void mark(int i) {
    const long long n = clock64();
    cyc[i] += n - t;
    t = n;
  }
};

// rht_lowp::admit<Int8Core, 4> with the score pass (3) and the appends (4)
// counted apart
__device__ __forceinline__ void timed_admit(int (&acc)[8][4][4], int r0, int N,
                                            const float* sq_t,
                                            const float* ts_t,
                                            const float* qq_s,
                                            const float* qs_s,
                                            const float* key_s, int* cnt_s,
                                            int2* slab0, int slab_len,
                                            int buf_at, Clock& clk,
                                            unsigned long long& appends) {
  constexpr int G = 4;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int row0 = warp * 32 + 2 * tig;
  float sn[8], ts[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int rl = row0 + 8 * (j / 2) + j % 2;
    sn[j] = r0 + rl < N ? sq_t[rl] : CUDART_INF_F;
    ts[j] = ts_t[rl];
  }
#pragma unroll
  for (int mh0 = 0; mh0 < 16; mh0 += G) {
    unsigned mask[G];
    unsigned any = 0;
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int m = (mh0 + u) / 2, h = (mh0 + u) % 2;
      const int ql = 16 * m + g + 8 * h;
      const float key = key_s[ql];
      const float qn = qq_s[ql];
      const float qsc = qs_s[ql];
      unsigned mk = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        auto& v = acc[m][j / 2][2 * h + j % 2];
        const float s = Int8Core::score(v, qn, qsc, sn[j], ts[j]);
        v = Int8Core::put(s);
        mk |= (unsigned)(s > key) << j;
      }
      mask[u] = mk;
      any |= mk;
    }
    const bool go = __any_sync(rht_lowp::FULL, any);
    clk.mark(3);
    if (!go) continue;
    int cnt[G], incl[G];
#pragma unroll
    for (int u = 0; u < G; ++u) incl[u] = cnt[u] = __popc(mask[u]);
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int up = __shfl_up_sync(rht_lowp::FULL, incl[u], 1, 4);
      if (tig >= 1) incl[u] += up;
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int up = __shfl_up_sync(rht_lowp::FULL, incl[u], 2, 4);
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
      slot[u] = __shfl_sync(rht_lowp::FULL, slot[u], 3, 4) + incl[u] - cnt[u];
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int m = (mh0 + u) / 2, h = (mh0 + u) % 2;
      const int ql = 16 * m + g + 8 * h;
      appends += __popc(mask[u]);
      for (unsigned bits = mask[u]; bits; bits &= bits - 1) {
        const int j = __ffs(bits) - 1;
        int v = acc[m][0][2 * h];
#pragma unroll
        for (int w = 1; w < 8; ++w) {
          v = j == w ? acc[m][w / 2][2 * h + w % 2] : v;
        }
        slab0[(size_t)ql * slab_len + buf_at + slot[u]++] = make_int2(
            __float_as_int(Int8Core::get(v)), r0 + row0 + 8 * (j / 2) + j % 2);
      }
    }
    clk.mark(4);
  }
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;
  clk.mark(3);
}

__global__ void __launch_bounds__(rht_lowp::THREADS, 2)
    timed_general_kernel(const unsigned char* __restrict__ Q,
                         const unsigned char* __restrict__ X,
                         const float* __restrict__ qq,
                         const float* __restrict__ qscale,
                         const float* __restrict__ sq,
                         const float* __restrict__ tscale, int B, int N,
                         int row_bytes, int k, int ntiles, int tiles_per_split,
                         int slab_len, int2* __restrict__ slabs) {
  using namespace rht_lowp;
  constexpr int CP = 16;
  Clock clk;
  clk.start();
  unsigned long long appends = 0, drains = 0;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const ring = smem;
  float* const sq_s = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  float* const ts_s = sq_s + STAGES * TILE;
  float* const qq_s = ts_s + STAGES * TILE;
  float* const qs_s = qq_s + TILE;
  float* const key_s = qs_s + TILE;
  int* const cnt_s = reinterpret_cast<int*>(key_s + TILE);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TILE;
  const int split = blockIdx.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  const int kch = max(1, (row_bytes + KB - 1) / KB);
  const int total = max(0, t_end - t_begin) * kch;
  const bool own_live = q0 + tid < B;
  int2* const slab0 = slabs + ((size_t)split * B + q0) * slab_len;
  int2* const heap = slab0 + (size_t)tid * slab_len + HEAP_AT;
  const int buf_at = heap_len(k);

  if (own_live) {
    for (int i = 0; i < k; ++i) heap[i] = empty_entry();
  }
  qq_s[tid] = own_live ? qq[q0 + tid] : 0.f;
  qs_s[tid] = own_live ? qscale[q0 + tid] : 0.f;
  key_s[tid] = own_live ? -CUDART_INF_F : CUDART_INF_F;
  cnt_s[tid] = 0;

  auto load = [&](int u) {
    const int t = t_begin + u / kch;
    const int part = u % kch;
    unsigned char* const st = ring + (u % STAGES) * STAGE_BYTES;
    load_operand<CP>(st, Q, B, row_bytes, q0, part * KB);
    load_operand<CP>(st + OPER_BYTES, X, N, row_bytes, t * TILE, part * KB);
    if (part == 0) {
      const int r = t * TILE + tid;
      cp_async<1>(sq_s + (t % STAGES) * TILE + tid, r < N ? sq + r : sq,
                  r < N ? 4 : 0);
      cp_async<1>(ts_s + (t % STAGES) * TILE + tid,
                  r < N ? tscale + r : tscale, r < N ? 4 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }

  int acc[8][4][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;
  clk.mark(0);
  for (int u = 0; u < total; ++u) {
    const int t = t_begin + u / kch;
    const int part = u % kch;
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (u + STAGES - 1 < total) load(u + STAGES - 1);
    cp_async_commit();
    clk.mark(1);
    const int steps = min(KB, row_bytes - part * KB + KSTEP - 1) / KSTEP;
    mma_chunk<Int8Core>(ring + (u % STAGES) * STAGE_BYTES, steps, acc);
    clk.mark(2);
    if (part + 1 < kch) continue;
    if (__syncthreads_or(cnt_s[tid] > DRAIN_AT)) {
      const int n = cnt_s[tid];
      if (n > 0) {
        key_s[tid] = __int_as_float(drain(heap, k, n).x);
        cnt_s[tid] = 0;
      }
      if (tid == 0) ++drains;
      __syncthreads();
    }
    clk.mark(5);
    timed_admit(acc, t * TILE, N, sq_s + (t % STAGES) * TILE,
                ts_s + (t % STAGES) * TILE, qq_s, qs_s, key_s, cnt_s, slab0,
                slab_len, buf_at, clk, appends);
  }
  cp_async_wait<0>();
  __syncthreads();
  clk.mark(1);
  if (own_live) {
    drain(heap, k, cnt_s[tid]);
    for (int m = k - 1; m >= 1; --m) {
      const int2 last = heap[m];
      heap[m] = heap[0];
      heap[0] = sift_down(heap, m, 0, last);
    }
  }
  clk.mark(6);
  if (tid % 32 == 0) {
    for (int i = 0; i < GPHASES; ++i) atomicAdd(&g_cycles[i], clk.cyc[i]);
  }
  atomicAdd(&g_appends, appends);
  atomicAdd(&g_drains, drains);
}

int general_splits(const Problem& p) {
  return plan_splits(rht_lowp::slots<Int8Core>(), (p.B + 127) / 128,
                     (p.N + 127) / 128);
}

float run_general(const Problem& p, int splits) {
  return best_ms([&] {
    CK((cudaError_t)rht_lowp::launch<Int8Core>(
        reinterpret_cast<const unsigned char*>(p.q),
        reinterpret_cast<const unsigned char*>(p.x), p.qq, p.qs, p.sq, p.ts,
        p.B, p.N, p.D, p.k, splits, p.slabs, p.out_s, p.out_i, 0));
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

// One launch of the instrumented general form: each phase's cycles a warp
// (averaged over the warps), drains a block, appends a (split, query);
// its outputs against `want`.
void general_phases(const Problem& p, int splits, const Outputs& want) {
  using namespace rht_lowp;
  const int ntiles = (p.N + TILE - 1) / TILE;
  const int per = (ntiles + splits - 1) / splits;
  const int slab_len = heap_len(p.k) + BUF_CAP;
  const dim3 grid((p.B + TILE - 1) / TILE, splits);
  CK(cudaFuncSetAttribute(timed_general_kernel,
                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                          SMEM_BYTES));
  unsigned long long zero[GPHASES] = {}, z = 0;
  CK(cudaMemcpyToSymbol(g_cycles, zero, sizeof(zero)));
  CK(cudaMemcpyToSymbol(g_drains, &z, sizeof(z)));
  CK(cudaMemcpyToSymbol(g_appends, &z, sizeof(z)));
  timed_general_kernel<<<grid, THREADS, SMEM_BYTES>>>(
      reinterpret_cast<const unsigned char*>(p.q),
      reinterpret_cast<const unsigned char*>(p.x), p.qq, p.qs, p.sq, p.ts,
      p.B, p.N, p.D, p.k, ntiles, per, slab_len, p.slabs);
  CK(cudaGetLastError());
  CK((cudaError_t)rht_scan::launch_merge(p.slabs, slab_len, p.B, p.k, splits,
                                         p.out_s, p.out_i, 0));
  CK(cudaDeviceSynchronize());
  Outputs got;
  got.read(p);
  unsigned long long cyc[GPHASES], drains, appends;
  CK(cudaMemcpyFromSymbol(cyc, g_cycles, sizeof(cyc)));
  CK(cudaMemcpyFromSymbol(&drains, g_drains, sizeof(drains)));
  CK(cudaMemcpyFromSymbol(&appends, g_appends, sizeof(appends)));
  const double warps = (double)grid.x * grid.y * (THREADS / 32);
  double sum = 0;
  for (int i = 0; i < GPHASES; ++i) sum += cyc[i] / warps;
  printf("general form, instrumented, B=%d N=%d k=%d (%s the shipped "
         "kernel's outputs), cycles a warp by phase:",
         p.B, p.N, p.k, got == want ? "equal to" : "DIFFERENT from");
  for (int i = 0; i < GPHASES; ++i) {
    printf(" %s %.0f (%.1f%%);", GPHASE_NAMES[i], cyc[i] / warps,
           100.0 * cyc[i] / warps / sum);
  }
  printf(" total %.0f; drains a block %.2f; appends a (split, query) %.1f; "
         "list_merge_kernel alone %.4f ms\n",
         sum, (double)drains / (grid.x * grid.y),
         (double)appends / ((double)splits * p.B), merge_ms(p, splits));
}

void general_figures() {
  cudaFuncAttributes a;
  CK(cudaFuncGetAttributes(&a, rht_lowp::lowp_tile_kernel<Int8Core, 16>));
  printf("general form lowp_tile_kernel<Int8Core, 16>: %d registers, %zu "
         "bytes local, %d bytes of dynamic shared memory, %d blocks per SM\n",
         a.numRegs, a.localSizeBytes, rht_lowp::SMEM_BYTES,
         rht_lowp::blocks_per_sm<Int8Core, 16>());
}


// -- the wgmma form -------------------------------------------------------

// ops/cuda_scan.py int8_wave_plan
int wave_splits(int slots, int B, int N) {
  const int tiles = std::max(1, (N + 127) / 128);
  const int q_tiles =
      std::max(1, (B + rht_int8::TILE_Q - 1) / rht_int8::TILE_Q);
  const int s = std::max(1, std::min(std::min(slots / q_tiles, tiles), 65535));
  const int per = (tiles + s - 1) / s;
  return (tiles + per - 1) / per;
}

// The wgmma form's cycle counters: a consumer warp's phases 0..7 and the
// producer's 8, 9 (rht_int8's P_* names), summed over warps by lane 0.
const char* const WPHASE_NAMES[rht_int8::PHASES] = {
    "set-up", "copy wait", "row terms (beta)",
    "mma (issue + wait for the last tile)", "drain (vote, drains, ranges)",
    "score epilogue (alpha, add-max a score, vote)",
    "admission (exact scores, appends)", "last drain + heap sort",
    "producer: stage wait", "producer: issue"};
__device__ unsigned long long g_wcycles[rht_int8::PHASES];
__device__ unsigned long long g_wcounts[rht_int8::COUNTS];

struct CycleProbe {
  static constexpr bool COUNTING = true;
  unsigned long long cyc[rht_int8::PHASES];
  unsigned long long cnt[rht_int8::COUNTS];
  long long t;
  __device__ void start() {
    for (int i = 0; i < rht_int8::PHASES; ++i) cyc[i] = 0;
    for (int i = 0; i < rht_int8::COUNTS; ++i) cnt[i] = 0;
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
      for (int i = 0; i < rht_int8::PHASES; ++i) {
        if (cyc[i]) atomicAdd(&g_wcycles[i], cyc[i]);
      }
    }
    for (int i = 0; i < rht_int8::COUNTS; ++i) {
      if (cnt[i]) atomicAdd(&g_wcounts[i], cnt[i]);
    }
  }
};

template <bool FILTER, int SETS, class Probe, class Tune = rht_int8::Tuning>
float run_wgmma(const Problem& p, int splits) {
  return best_ms([&] {
    CK(((cudaError_t)rht_int8::launch_form<FILTER, SETS, Probe, Tune>(
        reinterpret_cast<const unsigned char*>(p.q),
        reinterpret_cast<const unsigned char*>(p.x), p.qq, p.qs, p.sq, p.ts,
        p.B, p.N, p.D, p.k, splits, p.slabs, p.kshare, p.out_s, p.out_i,
        0)));
  });
}

// Other settings of the selection's knobs (scan_int8.cu Tuning).
template <int D, int R, bool S = true>
struct Knobs {
  static constexpr int DRAIN_AT = D;
  static constexpr int REFRESH = R;
  static constexpr bool SCORES = S;
};

template <bool FILTER, int SETS>
void wgmma_figures(const char* name) {
  cudaFuncAttributes a;
  CK(cudaFuncGetAttributes(
      &a, rht_int8::int8_tile_kernel<FILTER, SETS, rht_int8::NoProbe>));
  printf("wgmma form int8_tile_kernel<%s>: %d registers, %zu bytes local, %d "
         "bytes of dynamic shared memory at 128-byte rows, %d blocks per SM\n",
         name, a.numRegs, a.localSizeBytes, rht_int8::smem_bytes(128),
         rht_int8::blocks_per_sm<FILTER, SETS, rht_int8::NoProbe>(128));
}

// One launch of the instrumented wgmma form (FILTER, SETS): each
// phase's cycles a consumer warp (averaged over the 8 consumer warps of
// every block) and the producer's issuing lane's; its outputs against
// `want`.
template <bool FILTER, int SETS>
void wgmma_phases(const Problem& p, int splits, const Outputs& want) {
  const int blocks = ((p.B + rht_int8::TILE_Q - 1) / rht_int8::TILE_Q) * splits;
  unsigned long long zero[rht_int8::PHASES] = {};
  CK(cudaMemcpyToSymbol(g_wcycles, zero, sizeof(zero)));
  unsigned long long zc[rht_int8::COUNTS] = {};
  CK(cudaMemcpyToSymbol(g_wcounts, zc, sizeof(zc)));
  CK(((cudaError_t)rht_int8::launch_form<FILTER, SETS, CycleProbe>(
      reinterpret_cast<const unsigned char*>(p.q),
      reinterpret_cast<const unsigned char*>(p.x), p.qq, p.qs, p.sq, p.ts,
      p.B, p.N, p.D, p.k, splits, p.slabs, p.kshare, p.out_s, p.out_i, 0)));
  CK(cudaDeviceSynchronize());
  Outputs got;
  got.read(p);
  unsigned long long cyc[rht_int8::PHASES], cnt[rht_int8::COUNTS];
  CK(cudaMemcpyFromSymbol(cyc, g_wcycles, sizeof(cyc)));
  CK(cudaMemcpyFromSymbol(cnt, g_wcounts, sizeof(cnt)));
  double sum = 0;
  const double cw = 4.0 * rht_int8::CWG * blocks;  // consumer warps
  for (int i = 0; i < rht_int8::P_EMPTY_WAIT; ++i) sum += cyc[i] / cw;
  printf("wgmma form, epilogue %s, %d accumulator set%s, instrumented, "
         "B=%d N=%d k=%d (%s the general form's outputs), cycles a consumer "
         "warp by phase:",
         FILTER ? "(b) filter" : "(a) exact", SETS, SETS > 1 ? "s" : "",
         p.B, p.N, p.k,
         got == want ? "equal to" : "DIFFERENT from");
  for (int i = 0; i < rht_int8::P_EMPTY_WAIT; ++i) {
    printf(" %s %.0f (%.1f%%);", WPHASE_NAMES[i], cyc[i] / cw,
           100.0 * cyc[i] / cw / sum);
  }
  const double pairs = (double)p.B * p.N;
  printf(" total %.0f; the producer warp: %s %.0f, %s %.0f; warp epilogues "
         "%llu, %.2f%% of them on the exact path; values past the filter "
         "%.3g a (query, row), rows admitted %.3g a (query, row); "
         "list_merge_kernel alone %.4f ms\n",
         sum, WPHASE_NAMES[rht_int8::P_EMPTY_WAIT],
         cyc[rht_int8::P_EMPTY_WAIT] / (double)blocks,
         WPHASE_NAMES[rht_int8::P_ISSUE],
         cyc[rht_int8::P_ISSUE] / (double)blocks, cnt[rht_int8::C_EPILOGUES],
         100.0 * cnt[rht_int8::C_SLOW] / cnt[rht_int8::C_EPILOGUES],
         cnt[rht_int8::C_PASSED] / pairs, cnt[rht_int8::C_ADMITTED] / pairs,
         merge_ms(p, splits));
}

}  // namespace study

int main() {
  using namespace study;
  const int B = 2048, N = 1000064, D = 128;
  Problem p{};
  p.B = B;
  p.N = N;
  p.D = D;
  CK(cudaMalloc(&p.q, (size_t)B * D));
  CK(cudaMalloc(&p.x, (size_t)N * D));
  CK(cudaMalloc(&p.qq, B * 4));
  CK(cudaMalloc(&p.qs, B * 4));
  CK(cudaMalloc(&p.sq, (size_t)N * 4));
  CK(cudaMalloc(&p.ts, (size_t)N * 4));
  make_rows<<<(B + 7) / 8, 256>>>(B, D, 1, p.q, p.qs, p.qq);
  make_rows<<<(N + 7) / 8, 256>>>(N, D, 2, p.x, p.ts, p.sq);
  edit_rows<<<(N / 997 + 256) / 256, 256>>>(N, D, p.x, p.ts, p.sq, N / 2,
                                             N / 3);
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
  printf("%s, %d SMs; B=%d N=%d D=%d int8\n", prop.name,
         prop.multiProcessorCount, B, N, D);
  general_figures();
  wgmma_figures<true, 1>("(b) filter, 1 accumulator set");
  wgmma_figures<true, 2>("(b) filter, 2 accumulator sets");
  wgmma_figures<false, 1>("(a) exact, 1 accumulator set");
  printf("shipped: (b) filter, %d accumulator set(s); this build: %d "
         "consumer warpgroups, %d queries a block\n",
         rht_int8::SHIPPED_SETS, rht_int8::CWG, rht_int8::TILE_Q);
  const int ws = wave_splits(
      rht_int8::blocks_per_sm<true, rht_int8::SHIPPED_SETS, rht_int8::NoProbe>(
          128) * prop.multiProcessorCount, B, N);
  for (int k : {10, 80}) {
    p.k = k;
    const int gs = general_splits(p);
    const float ms = run_general(p, gs);
    Outputs want;
    want.read(p);
    printf("B=%d N=%d k=%d general form: %d splits, %.4f ms; query 0 top-2 "
           "ids %d %d sims %.9g %.9g\n",
           B, N, k, gs, ms, want.i[0], want.i[1], want.s[0], want.s[1]);
    const float b1 = run_wgmma<true, 1, rht_int8::NoProbe>(p, ws);
    Outputs got_b1;
    got_b1.read(p);
    const float b2 = run_wgmma<true, 2, rht_int8::NoProbe>(p, ws);
    Outputs got_b2;
    got_b2.read(p);
    const float a1 = run_wgmma<false, 1, rht_int8::NoProbe>(p, ws);
    Outputs got_a1;
    got_a1.read(p);
    printf("B=%d N=%d k=%d wgmma form: %d splits; epilogue (b) filter: 1 "
           "set %.4f ms (%s), 2 sets %.4f ms (%s); (a) exact, 1 set %.4f ms "
           "(%s); general / (b) 1 set %.2fx\n",
           B, N, k, ws, b1, got_b1 == want ? "equal" : "DIFFERENT", b2,
           got_b2 == want ? "equal" : "DIFFERENT", a1,
           got_a1 == want ? "equal" : "DIFFERENT", ms / b1);
    // the knobs, each run's outputs against the general form's
    printf("B=%d N=%d k=%d wgmma form, (b) filter, 1 set, by (DRAIN_AT, "
           "REFRESH) (shipped: (%d, %d)):",
           B, N, k, rht_int8::Tuning::DRAIN_AT, rht_int8::Tuning::REFRESH);
    auto knob = [&](auto tune, int d, int r) {
      const float ms =
          run_wgmma<true, 1, rht_int8::NoProbe, decltype(tune)>(p, ws);
      Outputs got;
      got.read(p);
      printf(" (%d, %d) %.4f ms%s;", d, r, ms,
             got == want ? "" : " DIFFERENT");
    };
    knob(Knobs<16, 4>{}, 16, 4);
    knob(Knobs<16, 16>{}, 16, 16);
    knob(Knobs<48, 16>{}, 48, 16);
    knob(Knobs<112, 16>{}, 112, 16);
    knob(Knobs<112, 4>{}, 112, 4);
    printf("\n");
    printf("B=%d N=%d k=%d wgmma form, MMAs and copies alone (no scores, "
           "timing only): %.4f ms\n", B, N, k,
           run_wgmma<true, 1, rht_int8::NoProbe, Knobs<16, 16, false>>(p, ws));
    general_phases(p, gs, want);
    wgmma_phases<true, 1>(p, ws, want);
    wgmma_phases<true, 2>(p, ws, want);
    wgmma_phases<false, 1>(p, ws, want);
  }
  return 0;
}
