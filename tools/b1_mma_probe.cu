// Probe of the tensor cores' integer forms that could score hamming
// distances on an H100, each a throughput loop of independent products:
//
// * mma.sync m16n8k32 s8 x s8 (kernel A′'s core), always built;
// * -DPROBE_B1: mma.sync m16n8k256 b1 x b1 .and.popc (popc(q & x) on the
//   packed words as they are; popc(q ^ x) = popc(q) + popc(x) -
//   2 popc(q & x)): kernel B′'s core; also kernel B′'s inner loop (the
//   product started from a row-term quad, two three-input maxima over
//   its four outputs) at 32 and 16 warps an SM, and with a distinct A
//   quad in each chain;
// * -DPROBE_B1_XOR: mma.sync m16n8k256 b1 x b1 .xor.popc (popc(q ^ x)
//   directly; PTX marks the b1 xor form deprecated on newer targets);
// * -DPROBE_WGMMA_B1: wgmma.mma_async m64n128k256 b1 x b1 .and.popc, both
//   operands K-major from shared memory (all ones, so every product
//   adds 256 to each accumulator: the probe checks the sum).
//
// Each b1 form sits behind its own flag, so that a ptxas that refuses
// one does not stop the others; build the four binaries side by side:
//
//   for f in "" -DPROBE_B1 -DPROBE_B1_XOR -DPROBE_WGMMA_B1; do
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 $f \
//         -o /tmp/probe$f tools/b1_mma_probe.cu & done; wait
//   for b in /tmp/probe*; do $b; done
//
// Prints, per form, its products per second on the card in m16n8
// products (a wgmma m64n128 product counts as 64 of them), and the
// equivalent rate in bit operations (a bit of q against a bit of x counts
// as 2 operations, as an int8 multiply-add does).

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

constexpr int CHAINS = 8;

enum Form { S8, B1_AND, B1_XOR, B1_AND_INIT, B1_AND_8A, B1_INIT_FOLD,
            B1_ZERO_MAX3, B1_INIT_MAX2 };

template <Form F>
__global__ void probe(int iters, int* out) {
  const unsigned t = threadIdx.x + 1;
  const unsigned a0 = t * 0x9E3779B9u, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7;
  const unsigned b0 = a0 ^ 0x55555555u, b1 = a1 ^ 0x33333333u;
  int c[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      if constexpr (F == S8) {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
#ifdef PROBE_B1
      if constexpr (F == B1_AND) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
#endif
#ifdef PROBE_B1
      if constexpr (F == B1_AND_INIT) {
        // kernel B′'s inner loop: d = a.b + (c0, c1, c0, c1) (a row term
        // that changes with the tile), then two three-input maxima fold
        // the four products into the chain's two running maxima
        int d[4];
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%10, %11, %10, %11};\n"
            : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
            : "r"(a0 + j), "r"(a1), "r"(a2), "r"(a3), "r"(b0 ^ it),
              "r"(b1), "r"(-it), "r"(it));
        c[j][0] = __vimax3_s32(c[j][0], d[0], d[1]);
        c[j][1] = __vimax3_s32(c[j][1], d[2], d[3]);
      }
      if constexpr (F == B1_INIT_FOLD || F == B1_ZERO_MAX3 ||
                    F == B1_INIT_MAX2) {
        // its parts: the row-term start with a one-op fold; a start from
        // 0 with the two three-input maxima; the row-term start with four
        // two-input maxima
        const bool zero = F == B1_ZERO_MAX3;
        int d[4];
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%10, %11, %10, %11};\n"
            : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
            : "r"(a0 + j), "r"(a1), "r"(a2), "r"(a3), "r"(b0 ^ it),
              "r"(b1), "r"(zero ? 0 : -it), "r"(zero ? 0 : it));
        if constexpr (F == B1_INIT_FOLD) {
          c[j][0] ^= d[0];
        } else if constexpr (F == B1_ZERO_MAX3) {
          c[j][0] = __vimax3_s32(c[j][0], d[0], d[1]);
          c[j][1] = __vimax3_s32(c[j][1], d[2], d[3]);
        } else {
          c[j][0] = max(max(c[j][0], d[0]), d[1]);
          c[j][1] = max(max(c[j][1], d[2]), d[3]);
        }
      }
      if constexpr (F == B1_AND_8A) {  // a distinct A quad each chain
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
            : "r"(a0 + j), "r"(a1 + j), "r"(a2 + j), "r"(a3 + j), "r"(b0),
              "r"(b1));
      }
#endif
#ifdef PROBE_B1_XOR
      if constexpr (F == B1_XOR) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
#endif
    }
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

void report(const char* name, cudaError_t err, float ms, double mmas,
            int k_depth) {
  const double ops = mmas * 16 * 8 * k_depth * 2;
  printf("%s: %s; %.4f ms, %.4g products/s, %.4g operations/s\n", name,
         cudaGetErrorString(err), ms, mmas / (ms * 1e-3), ops / (ms * 1e-3));
}

template <Form F>
void run(const char* name, int k_depth, int warps_per_sm = 32) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int threads = 256, iters = 4096;
  const int blocks = sms * warps_per_sm / 8;
  int* out = nullptr;
  cudaMalloc(&out, blocks * threads * sizeof(int));
  probe<F><<<blocks, threads>>>(16, out);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  probe<F><<<blocks, threads>>>(iters, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  report(name, cudaGetLastError(), ms,
         (double)blocks * (threads / 32) * iters * CHAINS, k_depth);
  cudaFree(out);
}

#ifdef PROBE_WGMMA_B1
// Two warpgroups a block; each issues GROUP products a commit group over
// one 64 x 1024-bit A tile and one 128 x 1024-bit B tile (K-major, the
// 128-byte swizzle: 8-row groups 1024 bytes apart, a 256-bit k-step 32
// bytes), keeping one group in flight.
constexpr int WG_THREADS = 256;
constexpr int GROUP = 8;
constexpr int WG_SMEM = 1024 + 64 * 128 + 128 * 128;

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_b1(int (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__global__ void __launch_bounds__(WG_THREADS)
    probe_wgmma(int iters, int* out) {
  extern __shared__ unsigned char raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~(uintptr_t)1023);
  for (int i = threadIdx.x; i < (64 + 128) * 128 / 4; i += blockDim.x) {
    reinterpret_cast<unsigned*>(sm)[i] = 0xffffffffu;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t a0 = (uint32_t)__cvta_generic_to_shared(sm);
  const uint32_t b0 = a0 + 64 * 128;
  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const uint32_t k = 32 * (j % 4);
      wgmma_b1(d, desc_sw128(a0 + k), desc_sw128(b0 + k));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  int s = 0, bad = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s += d[i];
    bad |= d[i] != 256 * GROUP * iters;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = bad ? -1 : s;
}

void run_wgmma() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = sms * 2, iters = 2048;
  int* out = nullptr;
  cudaMalloc(&out, blocks * WG_THREADS * sizeof(int));
  cudaFuncSetAttribute(probe_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       WG_SMEM);
  probe_wgmma<<<blocks, WG_THREADS, WG_SMEM>>>(16, out);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  probe_wgmma<<<blocks, WG_THREADS, WG_SMEM>>>(iters, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  const cudaError_t err = cudaGetLastError();
  int first = 0;
  cudaMemcpy(&first, out, sizeof(int), cudaMemcpyDeviceToHost);
  printf("wgmma sums %s (thread 0: %d)\n",
         first == 64 * 256 * GROUP * iters ? "right" : "WRONG", first);
  // 64 m16n8 products a wgmma m64n128
  report("wgmma m64n128k256 b1 and.popc", err, ms,
         (double)blocks * (WG_THREADS / 128) * iters * GROUP * 64, 256);
  cudaFree(out);
}
#endif

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s\n", prop.name);
  run<S8>("m16n8k32 s8", 32);
#ifdef PROBE_B1
  run<B1_AND>("m16n8k256 b1 and.popc", 256);
  run<B1_AND_INIT>("kernel B′'s inner loop, 32 warps an SM", 256);
  run<B1_AND_INIT>("kernel B′'s inner loop, 16 warps an SM", 256, 16);
  run<B1_AND>("m16n8k256 b1 and.popc, 16 warps an SM", 256, 16);
  run<B1_INIT_FOLD>("  its row-term start, a one-op fold", 256, 16);
  run<B1_ZERO_MAX3>("  its start from 0, two three-input maxima", 256, 16);
  run<B1_INIT_MAX2>("  its row-term start, four two-input maxima", 256, 16);
  run<B1_AND_8A>("m16n8k256 b1 and.popc, a distinct a each chain", 256);
#endif
#ifdef PROBE_B1_XOR
  run<B1_XOR>("m16n8k256 b1 xor.popc", 256);
#endif
#ifdef PROBE_WGMMA_B1
  run_wgmma();
#endif
  return 0;
}
