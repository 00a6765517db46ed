// Design study of kernel A′ (redis_hnsw_tpu_torch/csrc/scan_topk.cu): the
// shipped int8 tensor-core core (MmaCore) beside a popcount core on the
// CUDA cores (PopcCore: 8 x 16 int register tiles, queries ty + 16i and
// rows tx + 8j), and beside other forms of the shipped selection (how
// survivors leave the registers, when the buffers are merged), all in
// the shipped kernel (hamming_tile_kernel and list_merge_kernel), timed
// at the main path's shapes on synthetic words, their outputs compared
// byte for byte with the shipped core's (every form computes exact
// integer counts, so they must agree).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o /tmp/hamming_core_study tools/hamming_core_study.cu
//   /tmp/hamming_core_study
//
// Prints registers and local memory (spills) of both copy forms and
// resident blocks per SM of each form; one line per form and shape:
// splits, ms per launch (best of 3 runs of 5 launches, CUDA events) and
// whether the outputs equal the shipped core's; both cores with the
// selection taken out (timing only); and, from an instrumented copy of
// the kernel, where a block's cycles go (phases) and list_merge_kernel's
// time alone.

#include "../redis_hnsw_tpu_torch/csrc/scan_topk.cu"

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

using rht_ham::TILE;
using rht_ham::WC;

// The popcount core: count[i][j] += popc(q ^ x) per word, on the CUDA
// cores; the queries' words staged in shared memory as [word][query].
// Its filter: one branch-free pass asks whether this thread has a
// survivor; only then are its counts stored (local memory) with a bit per
// survivor, and a rolled loop appends them, one shared atomic each.
struct PopcCore {
  static constexpr int QS_BYTES = WC * TILE * 4;
  static constexpr int NEVER = INT_MIN;
  static constexpr int DRAIN_AT = rht_ham::BUF_CAP - TILE;
  struct Acc {
    int c[8][16];
  };
  __device__ static int key(int, int lim) { return lim; }
  __device__ static int count(int v, int) { return v; }
  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc.c[i][j] = 0;
  }
  __device__ static void stage(unsigned char* qs, const int* __restrict__ Q,
                               int B, int W, int q0, int w0, int wn) {
    int* qw = reinterpret_cast<int*>(qs);
    const int q = q0 + threadIdx.x;
#pragma unroll
    for (int j = 0; j < WC; ++j) {
      qw[j * TILE + threadIdx.x] =
          q < B && j < wn ? Q[(size_t)q * W + w0 + j] : 0;
    }
  }
  __device__ static void chunk(const unsigned char* qs, const int* xs, int wn,
                               Acc& acc) {
    const int* qw = reinterpret_cast<const int*>(qs);
    const int tx = threadIdx.x % 8;
    const int ty = threadIdx.x / 8;
#pragma unroll 2
    for (int j = 0; j < WC; ++j) {
      if (j >= wn) break;
      int q[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) q[i] = qw[j * TILE + ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int x = xs[(tx + 8 * jj) * WC + j];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc.c[i][jj] += __popc(q[i] ^ x);
      }
    }
  }
  template <class Live, class Emit>
  __device__ static void each(Acc& acc, const int* key_s, int* cnt_s,
                              Live&& live, Emit&& emit) {
    const int tx = threadIdx.x % 8;
    const int ty = threadIdx.x / 8;
    bool hit = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key = key_s[ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) hit |= acc.c[i][jj] < key;
    }
    if (hit) {
      int vals[128];
      unsigned bits[4] = {0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int key = key_s[ty + 16 * i];
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int v = acc.c[i][jj];
          vals[i * 16 + jj] = v;
          bits[i / 2] |= (unsigned)(v < key) << ((i % 2) * 16 + jj);
        }
      }
#pragma unroll 1
      for (int w = 0; w < 4; ++w) {
        for (unsigned b = bits[w]; b; b &= b - 1) {
          const int idx = 32 * w + __ffs(b) - 1;
          const int ql = ty + 16 * (idx / 16), rl = tx + 8 * (idx % 16);
          if (live(rl)) emit(ql, rl, vals[idx], atomicAdd(&cnt_s[ql], 1));
        }
      }
    }
    zero(acc);
  }
};

// The int8 core with the popcount core's filter (per thread: a
// branch-free pass, then its counts through local memory and one shared
// atomic a survivor), where the shipped core aggregates a warp's
// survivors of a query into one atomic.
struct MmaLocal : rht_ham::MmaCore {
  template <class Live, class Emit>
  __device__ static void each(Acc& acc, const int* key_s, int* cnt_s,
                              Live&& live, Emit&& emit) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int tig = lane % 4;
    bool hit = false;
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = key_s[16 * m + g + 8 * h];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          hit |= (acc.c[m][n][2 * h] > key) | (acc.c[m][n][2 * h + 1] > key);
      }
    if (hit) {
      int vals[128];
      unsigned bits[4] = {0, 0, 0, 0};
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = key_s[16 * m + g + 8 * h];
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = ((m * 2 + h) * 4 + n) * 2 + e;
              const int v = acc.c[m][n][2 * h + e];
              vals[i] = v;
              bits[i / 32] |= (unsigned)(v > key) << (i % 32);
            }
        }
#pragma unroll 1
      for (int w = 0; w < 4; ++w) {
        for (unsigned b = bits[w]; b; b &= b - 1) {
          const int i = 32 * w + __ffs(b) - 1;
          const int e = i & 1, n = (i >> 1) & 3, h = (i >> 3) & 1;
          const int ql = 16 * (i >> 4) + g + 8 * h;
          const int rl = warp * 32 + 8 * n + 2 * tig + e;
          if (live(rl)) emit(ql, rl, vals[i], atomicAdd(&cnt_s[ql], 1));
        }
      }
    }
    zero(acc);
  }
};

// The shipped core merging its buffers once one holds more than AT
// entries (the shipped core: 16; at most BUF_CAP - TILE = 128): the
// lower, the fresher the keys, the fewer appends and the more merges.
template <int AT>
struct MmaDrainAt : rht_ham::MmaCore {
  static constexpr int DRAIN_AT = AT;
};

// The shipped core's appends with G (m, h) groups to a branch (the
// shipped core: 4; 16 is every group of a warp behind one vote).
template <int G>
struct MmaGroups : rht_ham::MmaCore {
  template <class Live, class Emit>
  __device__ static void each(Acc& acc, const int* key_s, int* cnt_s,
                              Live&& live, Emit&& emit) {
    rht_ham::MmaCore::each<G>(acc, key_s, cnt_s, live, emit);
  }
};

// A core with its selection taken out (timing only: its outputs are
// not the top k): the accumulators are folded into one value instead of
// being filtered, so the time left is the scoring loop, the ring and the
// barriers.
template <class Core>
struct LoopOnly : Core {
  template <class Live, class Emit>
  __device__ static void each(typename Core::Acc& acc, const int*, int*,
                              Live&&, Emit&& emit) {
    int* v = reinterpret_cast<int*>(&acc);
    int x = 0;
#pragma unroll
    for (int i = 0; i < (int)(sizeof(acc) / 4); ++i) x ^= v[i];
    Core::zero(acc);
    if (x == 0x5eed5eed) emit(0, 0, x, 0);
  }
};

// ops/cuda_select.py plan_splits with ops/cuda_scan.py's
// HAMMING_SPLIT_TILES, as ops/cuda_scan.py plan calls it for kernel A′
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

// Where a block's time goes: a copy of the shipped hamming_tile_kernel
// (16-byte form) whose warps read clock64() around each part of a tile
// and add the cycles to PHASES counters; and counts of merges (drains)
// and appends. Timing only: the counters cost a little themselves.
constexpr int PHASES = 7;
const char* const PHASE_NAMES[PHASES] = {
    "set-up", "ring wait + barrier", "query expansion + mma",
    "merge vote", "drains", "key pass + appends", "last drain + heap sort"};
__device__ unsigned long long g_cycles[PHASES];
__device__ unsigned long long g_drains, g_appends;

template <class Core>
__global__ void __launch_bounds__(rht_ham::THREADS, 2)
    timed_tile_kernel(const int* __restrict__ Q, const int* __restrict__ X,
                      const float* __restrict__ bias, int B, int N, int W,
                      int k, int ntiles, int tiles_per_split, int slab_len,
                      int2* __restrict__ slabs) {
  using namespace rht_ham;
  extern __shared__ __align__(16) unsigned char smem[];
  int* const ring = reinterpret_cast<int*>(smem);
  float* const bias_s = reinterpret_cast<float*>(ring + STAGES * STAGE_WORDS);
  unsigned char* const qs =
      reinterpret_cast<unsigned char*>(bias_s + STAGES * TILE);
  int* const popc_s = reinterpret_cast<int*>(qs + Core::QS_BYTES);
  int* const key_s = popc_s + TILE;
  int* const cnt_s = key_s + TILE;
  unsigned long long cyc[PHASES] = {};
  long long t_last = clock64();
  auto mark = [&](int phase) {
    const long long now = clock64();
    cyc[phase] += now - t_last;
    t_last = now;
  };
  int drains = 0, appends = 0;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TILE;
  const int split = blockIdx.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  const int nch = max(1, (W + WC - 1) / WC);
  const int total = max(0, t_end - t_begin) * nch;
  const bool own_live = q0 + tid < B;
  int2* const slab0 = slabs + ((size_t)split * B + q0) * slab_len;
  int2* const heap = slab0 + (size_t)tid * slab_len + HEAP_AT;
  const int buf_at = heap_len(k);

  int popcq = 0;
  if (own_live) {
    for (int w = 0; w < W; ++w) popcq += __popc(Q[(size_t)(q0 + tid) * W + w]);
    for (int i = 0; i < k; ++i) heap[i] = empty_entry();
  }
  popc_s[tid] = popcq;
  key_s[tid] = own_live ? Core::key(popcq, INT_MAX) : Core::NEVER;
  cnt_s[tid] = 0;

  auto load = [&](int u) {
    const int t = t_begin + u / nch;
    const int part = u % nch;
    load_words<4>(ring + (u % STAGES) * STAGE_WORDS, X, N, W, t * TILE,
                  part * WC);
    if (part == 0) {
      const int r = t * TILE + tid;
      cp_async<1>(bias_s + (t % STAGES) * TILE + tid, r < N ? bias + r : bias,
                  r < N ? 4 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }

  typename Core::Acc acc;
  Core::zero(acc);
  mark(0);
  for (int u = 0; u < total; ++u) {
    const int t = t_begin + u / nch;
    const int part = u % nch;
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (u + STAGES - 1 < total) load(u + STAGES - 1);
    cp_async_commit();
    mark(1);
    const int w0 = part * WC;
    const int wn = min(WC, W - w0);
    if (nch > 1 || u == 0) {
      Core::stage(qs, Q, B, W, q0, w0, wn);
      __syncthreads();
    }
    Core::chunk(qs, ring + (u % STAGES) * STAGE_WORDS, wn, acc);
    if (part + 1 < nch) continue;
    // the accumulators are read here, so the mma work is in phase 2
    int sink = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) sink |= reinterpret_cast<const int*>(&acc)[e];
    if (sink == 0x5eed5eed) cyc[0] += 1;
    mark(2);

    auto merge = [&] {
      const bool any = __syncthreads_or(cnt_s[tid] > Core::DRAIN_AT);
      mark(3);
      if (any) {
        const int n = cnt_s[tid];
        if (n > 0) {
          key_s[tid] = Core::key(popcq, count_limit(drain(heap, k, n)));
          cnt_s[tid] = 0;
        }
        __syncthreads();
        ++drains;
        mark(4);
      }
    };
    merge();
    const int r0 = t * TILE;
    const float* const bias_t = bias_s + (t % STAGES) * TILE;
    Core::each(
        acc, key_s, cnt_s,
        [&](int rl) { return r0 + rl < N && bias_t[rl] != -CUDART_INF_F; },
        [&](int ql, int rl, int v, int slot) {
          const float s = __fsub_rn(
              bias_t[rl], __int2float_rn(Core::count(v, popc_s[ql])));
          slab0[(size_t)ql * slab_len + buf_at + slot] =
              make_int2(__float_as_int(s), r0 + rl);
          ++appends;
        });
    mark(5);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (own_live) {
    drain(heap, k, cnt_s[tid]);
    for (int m = k - 1; m >= 1; --m) {
      const int2 last = heap[m];
      heap[m] = heap[0];
      heap[0] = sift_down(heap, m, 0, last);
    }
  }
  mark(6);
  if (tid % 32 == 0) {
    for (int i = 0; i < PHASES; ++i) atomicAdd(&g_cycles[i], cyc[i]);
  }
  atomicAdd(&g_appends, (unsigned long long)appends);
  if (tid == 0) atomicAdd(&g_drains, (unsigned long long)drains);
}

struct Problem {
  int B, N, W, k;
  int* q;
  int* x;
  float* bias;
  int2* slabs;
  float* out_s;
  int* out_i;
};

template <class Core>
void forms(const char* name) {
  cudaFuncAttributes a4, a1;
  CK(cudaFuncGetAttributes(&a4, rht_ham::hamming_tile_kernel<Core, 4>));
  CK(cudaFuncGetAttributes(&a1, rht_ham::hamming_tile_kernel<Core, 1>));
  printf("%s: <4> %d registers, %zu bytes local; <1> %d registers, %zu "
         "bytes local; %d bytes of shared memory; %d blocks per SM\n",
         name, a4.numRegs, a4.localSizeBytes, a1.numRegs, a1.localSizeBytes,
         rht_ham::smem_bytes<Core>(),
         std::min(rht_ham::blocks_per_sm<Core, 4>(),
                  rht_ham::blocks_per_sm<Core, 1>()));
}

// One launch of timed_tile_kernel<Core> (16-byte form): each phase's
// cycles per warp, averaged over the warps, then the merges per block and
// the appends per (split, query). Then list_merge_kernel alone over the
// slabs it left, in ms.
template <class Core>
void phases(const Problem& p, int splits, const char* name) {
  const int ntiles = (p.N + TILE - 1) / TILE;
  const int per = (ntiles + splits - 1) / splits;
  const int slab_len = rht_ham::heap_len(p.k) + rht_ham::BUF_CAP;
  const dim3 grid((p.B + TILE - 1) / TILE, splits);
  const int smem = rht_ham::smem_bytes<Core>();
  CK(cudaFuncSetAttribute(timed_tile_kernel<Core>,
                          cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  unsigned long long zero[PHASES] = {}, z = 0;
  CK(cudaMemcpyToSymbol(g_cycles, zero, sizeof(zero)));
  CK(cudaMemcpyToSymbol(g_drains, &z, sizeof(z)));
  CK(cudaMemcpyToSymbol(g_appends, &z, sizeof(z)));
  timed_tile_kernel<Core><<<grid, rht_ham::THREADS, smem>>>(
      p.q, p.x, p.bias, p.B, p.N, p.W, p.k, ntiles, per, slab_len, p.slabs);
  CK(cudaGetLastError());
  CK(cudaDeviceSynchronize());
  unsigned long long cyc[PHASES], drains, appends;
  CK(cudaMemcpyFromSymbol(cyc, g_cycles, sizeof(cyc)));
  CK(cudaMemcpyFromSymbol(&drains, g_drains, sizeof(drains)));
  CK(cudaMemcpyFromSymbol(&appends, g_appends, sizeof(appends)));
  const double warps = (double)grid.x * grid.y * (rht_ham::THREADS / 32);
  double sum = 0;
  printf("B=%d N=%d k=%d %s, cycles a warp by phase:", p.B, p.N, p.k, name);
  for (int i = 0; i < PHASES; ++i) {
    printf(" %s %.0f;", PHASE_NAMES[i], cyc[i] / warps);
    sum += cyc[i] / warps;
  }
  printf(" total %.0f; merges a block %.2f; appends a (split, query) %.1f\n",
         sum, (double)drains / (grid.x * grid.y),
         (double)appends / ((double)splits * p.B));
  cudaEvent_t e0, e1;
  CK(cudaEventCreate(&e0));
  CK(cudaEventCreate(&e1));
  CK(cudaEventRecord(e0));
  for (int i = 0; i < 5; ++i) {
    CK((cudaError_t)rht_scan::launch_merge(p.slabs, slab_len, p.B, p.k,
                                           splits, p.out_s, p.out_i, 0));
  }
  CK(cudaEventRecord(e1));
  CK(cudaEventSynchronize(e1));
  float ms = 0;
  CK(cudaEventElapsedTime(&ms, e0, e1));
  printf("B=%d N=%d k=%d list_merge_kernel alone over %d splits: %.4f ms\n",
         p.B, p.N, p.k, splits, ms / 5);
}

template <class Core>
float run(const Problem& p, int splits) {
  auto launch = [&] {
    CK((cudaError_t)rht_ham::launch<Core>(p.q, p.x, p.bias, p.B, p.N, p.W,
                                          p.k, splits, p.slabs, p.out_s,
                                          p.out_i, 0));
  };
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
  return best;
}

}  // namespace study

int main() {
  using namespace study;
  const int N = 1000064, W = 8, BMAX = 2048;
  std::vector<int> hq((size_t)BMAX * W), hx((size_t)N * W);
  std::vector<float> hb(N, 0.f);
  uint64_t state = 12345;  // a fixed-seed LCG
  auto next = [&] {
    state = state * 6364136223846793005ULL + 1442695040888963407ULL;
    return (int)(state >> 32);
  };
  for (auto& v : hq) v = next();
  for (auto& v : hx) v = next();
  for (int w = 0; w < W; ++w) {  // query 0 at distance 0, twice
    hx[(size_t)(N / 2) * W + w] = hx[(size_t)(N / 3) * W + w] = hq[w];
  }
  for (int n = 0; n < N; n += 997) hb[n] = -INFINITY;  // dead rows
  Problem p{};
  p.N = N;
  p.W = W;
  CK(cudaMalloc(&p.q, hq.size() * 4));
  CK(cudaMalloc(&p.x, hx.size() * 4));
  CK(cudaMalloc(&p.bias, N * 4));
  CK(cudaMemcpy(p.q, hq.data(), hq.size() * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(p.x, hx.data(), hx.size() * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(p.bias, hb.data(), N * 4, cudaMemcpyHostToDevice));
  const size_t slab_bytes = (size_t)260 * BMAX * (rht_ham::heap_len(40) +
                                                 rht_ham::BUF_CAP) * 8;
  CK(cudaMalloc(&p.slabs, slab_bytes));
  CK(cudaMalloc(&p.out_s, (size_t)BMAX * 40 * 4));
  CK(cudaMalloc(&p.out_i, (size_t)BMAX * 40 * 4));
  cudaDeviceProp prop;
  CK(cudaGetDeviceProperties(&prop, 0));
  printf("%s, N=%d W=%d\n", prop.name, N, W);
  forms<rht_ham::MmaCore>("int8 mma core (shipped)");
  forms<PopcCore>("popcount core");
  forms<MmaLocal>("int8 mma core, per-thread survivors");
  forms<MmaGroups<16>>("int8 mma core, 16 groups a branch");
  forms<MmaGroups<1>>("int8 mma core, 1 group a branch");
  forms<MmaGroups<2>>("int8 mma core, 2 groups a branch");
  std::vector<float> want_s, got_s;
  std::vector<int> want_i, got_i;
  struct Shape {
    int B, N, k;
  };
  for (Shape s : {Shape{2048, N, 40}, Shape{2048, N, 10}, Shape{16, N, 10},
                  Shape{2048, 16384, 10}}) {
    p.B = s.B;
    p.N = s.N;
    p.k = s.k;
    const int ntiles = (s.N + TILE - 1) / TILE;
    const int q_tiles = (s.B + TILE - 1) / TILE;
    const size_t outs = (size_t)s.B * s.k;
    // one core's time at this shape, its outputs against the shipped
    // core's (which runs first)
    auto time = [&](auto core, const char* name) {
      using Core = decltype(core);
      const int splits =
          plan_splits(rht_ham::slots<Core>(), q_tiles, ntiles);
      if ((size_t)splits * s.B * (rht_ham::heap_len(s.k) + rht_ham::BUF_CAP) *
              8 > slab_bytes) {
        printf("slabs too small\n");
        exit(1);
      }
      const float ms = run<Core>(p, splits);
      const bool first = want_s.size() != outs || name == nullptr;
      std::vector<float>& os = first ? want_s : got_s;
      std::vector<int>& oi = first ? want_i : got_i;
      os.resize(outs);
      oi.resize(outs);
      CK(cudaMemcpy(os.data(), p.out_s, outs * 4, cudaMemcpyDeviceToHost));
      CK(cudaMemcpy(oi.data(), p.out_i, outs * 4, cudaMemcpyDeviceToHost));
      const bool same =
          first || (oi == want_i &&
                    memcmp(want_s.data(), got_s.data(), outs * 4) == 0);
      printf("B=%d N=%d k=%d %s: %d splits, %.4f ms%s; query 0 top-2 ids "
             "%d %d sims %g %g\n",
             s.B, s.N, s.k, name ? name : "int8 mma core (shipped)", splits,
             ms, first ? "" : (same ? ", equal" : ", DIFFERENT"), oi[0], oi[1],
             os[0], os[1]);
    };
    want_s.clear();
    time(rht_ham::MmaCore{}, nullptr);
    time(PopcCore{}, "popcount core");
    time(MmaLocal{}, "int8 mma core, per-thread survivors");
    time(MmaDrainAt<128>{}, "int8 mma core, merging above 128");
    time(MmaDrainAt<32>{}, "int8 mma core, merging above 32");
    time(MmaDrainAt<8>{}, "int8 mma core, merging above 8");
    time(MmaGroups<1>{}, "int8 mma core, 1 group a branch");
    time(MmaGroups<2>{}, "int8 mma core, 2 groups a branch");
    time(MmaGroups<16>{}, "int8 mma core, 16 groups a branch");
  }
  p.B = 2048;
  p.N = N;
  p.k = 10;
  const int splits = plan_splits(rht_ham::slots<rht_ham::MmaCore>(), 16,
                                 (N + TILE - 1) / TILE);
  printf("B=2048 N=%d k=10, selection taken out (timing only): int8 mma "
         "core %.4f ms, popcount core %.4f ms\n",
         N, run<LoopOnly<rht_ham::MmaCore>>(p, splits),
         run<LoopOnly<PopcCore>>(p, splits));
  for (int k : {10, 40}) {
    p.k = k;
    phases<rht_ham::MmaCore>(p, splits, "int8 mma core (shipped)");
    phases<MmaLocal>(p, splits, "int8 mma core, per-thread survivors");
    phases<MmaGroups<1>>(p, splits, "int8 mma core, 1 group a branch");
  }
  // The planner's split count against others: fewer splits mean longer
  // splits, fewer survivors and merges, but fewer blocks to a wave.
  for (int k : {10, 40}) {
    p.k = k;
    printf("B=2048 N=%d k=%d shipped core by split count (planned: %d):", N,
           k, splits);
    for (int s : {8, 16, 33, 66}) {
      printf(" %d splits %.4f ms;", s, run<rht_ham::MmaCore>(p, s));
    }
    printf("\n");
  }
  return 0;
}
