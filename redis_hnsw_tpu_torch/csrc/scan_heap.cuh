// The selection that kernels A and A′ (scan_topk.cu) and the bf16 and
// int8 scan cores (scan_lowp.cu) share: per (split, query) a slab in
// device memory holding an 8-ary heap of the split's best k entries and an
// append buffer, the owner's drain of the buffer into the heap, the heap
// sift, and list_merge_kernel, which merges the splits' sorted lists per
// query under the total order (-score, row id). An entry is an int2: a
// float score's bits and its row id. The design is described at the top
// of scan_topk.cu.

#pragma once

#include <cfloat>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "l2_core.cuh"

namespace rht_scan {

using namespace rht_l2;

// entries of a (split, query) append buffer: a tile adds at most TILE_R,
// and the block merges before a tile once any buffer holds BUF_CAP -
// TILE_R or more, so no tile overflows one (the first merge comes after
// the first tile)
constexpr int BUF_CAP = 2 * TILE_R;
constexpr int MERGE_WARPS = 4;

// Entries of one (split, query) slab: an ARITY-ary heap g[0..k) at slab
// offset HEAP_AT, then the append buffer. Node i's children g[8i + 1 ..
// 8i + 8] sit at slab offset 8(i + 1), four aligned 16-byte loads (a slab
// is a multiple of 8 entries); the heap region covers every child slot
// that a sift reads.
constexpr int ARITY = 8;
constexpr int HEAP_AT = ARITY - 1;
__host__ __device__ __forceinline__ int heap_len(int k) {
  return (k + HEAP_AT + 2 * ARITY - 1) & ~(ARITY - 1);
}

// An entry: a score's bits and its row id.
__device__ __forceinline__ bool beats(int2 a, int2 b) {
  const float as = __int_as_float(a.x), bs = __int_as_float(b.x);
  return as > bs || (as == bs && a.y < b.y);
}

// An empty heap slot: every real row beats it.
__device__ __forceinline__ int2 empty_entry() {
  return make_int2(__float_as_int(-CUDART_INF_F), -1);
}

// A query's admission threshold from its heap's root: a score enters the
// buffer iff score >= threshold. Ties at the root's score are admitted
// and settled by id in the heap; -FLT_MAX keeps dead rows (-inf) out of
// an empty heap.
__device__ __forceinline__ float threshold(int2 root) {
  return fmaxf(__int_as_float(root.x), -FLT_MAX);
}

// In the heap every node beats or equals its parent, so the root is the
// worst entry. Sift c down from node i of g[0..n): returns the entry that
// node i then holds and writes the nodes below it (not node i itself, so
// the caller may keep it in a register).
__device__ __forceinline__ int2 sift_down(int2* g, int n, int i, int2 c) {
  int2 top = c;
  int cur = i;
  for (;;) {
    const int c1 = ARITY * cur + 1;
    if (c1 >= n) break;
    const int4* p = reinterpret_cast<const int4*>(g + c1);
    const int4 v[ARITY / 2] = {p[0], p[1], p[2], p[3]};
    int2 w = make_int2(v[0].x, v[0].y);
    int wi = c1;
#pragma unroll
    for (int u = 1; u < ARITY; ++u) {
      const int2 e = u % 2 ? make_int2(v[u / 2].z, v[u / 2].w)
                           : make_int2(v[u / 2].x, v[u / 2].y);
      if (c1 + u < n && beats(w, e)) {
        w = e;
        wi = c1 + u;
      }
    }
    if (!beats(c, w)) break;
    if (cur == i) {
      top = w;
    } else {
      g[cur] = w;
    }
    cur = wi;
  }
  if (cur != i) g[cur] = c;
  return top;
}

// The owner lane's merge of its buffer (n entries) into its heap g (k
// entries): every buffered entry that beats the root replaces it. The
// root and its ARITY children are held in registers meanwhile, so an
// insertion reads device memory only below them (none for k <= 9, one
// level of loads for k <= 73). Returns the new root. The buffer is read
// DRAIN_BATCH entries at a time, so the loads overlap.
constexpr int DRAIN_BATCH = 4;
__device__ __forceinline__ int2 drain(int2* g, int k, int n) {
  const int2* buf = g - HEAP_AT + heap_len(k);
  const int n1 = min(k - 1, ARITY);  // children of the root: g[1..n1]
  int2 root = g[0];
  int2 l1[ARITY];
  {
    const int4* p = reinterpret_cast<const int4*>(g + 1);
#pragma unroll
    for (int u = 0; u < ARITY / 2; ++u) {
      const int4 v = p[u];
      l1[2 * u] = make_int2(v.x, v.y);
      l1[2 * u + 1] = make_int2(v.z, v.w);
    }
  }
  for (int e0 = 0; e0 < n; e0 += DRAIN_BATCH) {
    int2 cb[DRAIN_BATCH];
#pragma unroll
    for (int u = 0; u < DRAIN_BATCH; ++u) {
      // written by other lanes of the warp: read past the SM's L1
      cb[u] = e0 + u < n ? __ldcg(buf + e0 + u) : empty_entry();
    }
#pragma unroll
    for (int u = 0; u < DRAIN_BATCH; ++u) {
      const int2 c = cb[u];
      if (!beats(c, root)) continue;
      int2 w = l1[0];
      int wi = 0;
#pragma unroll
      for (int v = 1; v < ARITY; ++v) {
        if (v < n1 && beats(w, l1[v])) {
          w = l1[v];
          wi = v;
        }
      }
      if (n1 == 0 || !beats(c, w)) {
        root = c;
        continue;
      }
      root = w;
      const int2 top = sift_down(g, k, 1 + wi, c);
#pragma unroll
      for (int v = 0; v < ARITY; ++v) {
        if (v == wi) l1[v] = top;
      }
    }
  }
  g[0] = root;
#pragma unroll
  for (int v = 0; v < ARITY; ++v) {
    if (v < n1) g[1 + v] = l1[v];
  }
  return root;
}

// Per query, the best k of the `splits` sorted lists g[0..k) of its
// slabs, (-inf, -1) past the last real entry.
__global__ void __launch_bounds__(32 * MERGE_WARPS)
    list_merge_kernel(const int2* __restrict__ slabs, int slab_len, int B,
                      int k, int splits, float* __restrict__ out_s,
                      int* __restrict__ out_i) {
  extern __shared__ int next_s[];  // [MERGE_WARPS][splits]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.x * MERGE_WARPS + warp;
  if (q >= B) return;  // whole warps only; no block barrier below
  int* const next = next_s + warp * splits;
  for (int l = lane; l < splits; l += 32) next[l] = 0;
  __syncwarp();
  const int2* const lists = slabs + (size_t)q * slab_len + HEAP_AT;
  const size_t stride = (size_t)B * slab_len;
  // this lane's best head over lists lane, lane + 32, ...
  auto rescan = [&](int2& best, int& bl) {
    best = empty_entry();
    bl = -1;
    for (int l = lane; l < splits; l += 32) {
      const int p = next[l];
      if (p >= k) continue;
      const int2 e = lists[l * stride + p];
      if (bl < 0 || beats(e, best)) {
        best = e;
        bl = l;
      }
    }
  };
  int2 head;
  int hl;
  rescan(head, hl);
  for (int j = 0; j < k; ++j) {
    int2 b = head;
    int wl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int2 o = make_int2(__shfl_xor_sync(FULL_MASK, b.x, off),
                               __shfl_xor_sync(FULL_MASK, b.y, off));
      const int ol = __shfl_xor_sync(FULL_MASK, wl, off);
      if (beats(o, b) || (!beats(b, o) && ol < wl)) {
        b = o;
        wl = ol;
      }
    }
    const float bs = __int_as_float(b.x);
    const bool valid = bs > -CUDART_INF_F;
    if (lane == 0) {
      out_s[(size_t)q * k + j] = valid ? bs : -CUDART_INF_F;
      out_i[(size_t)q * k + j] = valid ? b.y : -1;
    }
    if (!valid) {
      // every list is spent: pad the rest of the row
      for (int jj = j + 1 + lane; jj < k; jj += 32) {
        out_s[(size_t)q * k + jj] = -CUDART_INF_F;
        out_i[(size_t)q * k + jj] = -1;
      }
      break;
    }
    if (lane == wl) {
      ++next[hl];
      rescan(head, hl);
    }
    __syncwarp();
  }
}

// The splits' shared k-th best of the warpgroup-MMA forms (scan_int8.cu,
// scan_bf16.cu): per query, the largest heap root (the k-th best score of
// a split's rows so far, once its heap is full) any split has published,
// as an order-keeping unsigned (0: none). The final k-th best is at least
// that, so a split may drop any row scoring below it: no such row is
// among the final k (rows tying it are kept, for the lowest-id rule).
__device__ __forceinline__ unsigned key_enc(float f) {
  const unsigned u = __float_as_uint(f);
  return u & 0x80000000u ? ~u : u | 0x80000000u;
}

__device__ __forceinline__ float key_dec(unsigned e) {
  if (e == 0u) return -CUDART_INF_F;
  return __uint_as_float(e & 0x80000000u ? e & 0x7fffffffu : ~e);
}

// The admission key of a split whose heap root scores `root`, given the
// shared k-th best `ext`: admit a row iff it scores above the root and at
// least ext, i.e. above the larger of root and the float below ext.
__device__ __forceinline__ float admission_key(float root, float ext) {
  return ext > -CUDART_INF_F ? fmaxf(root, nextafterf(ext, -CUDART_INF_F))
                             : root;
}

// The current card's SM count, or a negative value on failure.
inline int card_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return -1;
  }
  return sms;
}

// Launch list_merge_kernel over the slabs of a split kernel (A or A′).
inline int launch_merge(const int2* slabs, int slab_len, int B, int k,
                        int splits, float* out_s, int* out_i,
                        cudaStream_t stream) {
  const int merge_smem = MERGE_WARPS * splits * (int)sizeof(int);
  if (merge_smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        list_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        merge_smem);
    if (err != cudaSuccess) return (int)err;
  }
  list_merge_kernel<<<(B + MERGE_WARPS - 1) / MERGE_WARPS, 32 * MERGE_WARPS,
                      merge_smem, stream>>>(slabs, slab_len, B, k, splits,
                                            out_s, out_i);
  return (int)cudaGetLastError();
}

}  // namespace rht_scan
