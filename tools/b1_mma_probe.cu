// Probe of the tensor cores' two integer forms that could score hamming
// distances on an H100: mma.sync m16n8k32 s8 x s8 (kernel A′'s core) and
// m16n8k256 b1 x b1 with .and.popc (popc(q & x) on the packed words as
// they are; popc(q ^ x) = popc(q) + popc(x) - 2 popc(q & x)). A
// throughput loop of independent products on register operands, one per
// form; the b1 form only when built with -DPROBE_B1, so that a ptxas that
// refuses it does not stop the s8 probe.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o /tmp/probe tools/b1_mma_probe.cu && /tmp/probe
//   nvcc ... -DPROBE_B1 -o /tmp/probe_b1 tools/b1_mma_probe.cu && /tmp/probe_b1
//
// Prints, per form, products per second on the card and the equivalent
// rate in hamming bit operations (a bit of q against a bit of x counts
// as 2 operations, as an int8 multiply-add does).

#include <cstdio>
#include <cuda_runtime.h>

constexpr int CHAINS = 8;

template <int BITS>
__global__ void probe(int iters, int* out) {
  const unsigned t = threadIdx.x + 1;
  const unsigned a0 = t * 0x9E3779B9u, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7;
  const unsigned b0 = a0 ^ 0x55555555u, b1 = a1 ^ 0x33333333u;
  int c[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      if constexpr (BITS == 1) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int BITS>
void run(const char* name, int k_depth) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = sms * 4, threads = 256, iters = 4096;
  int* out = nullptr;
  cudaMalloc(&out, blocks * threads * sizeof(int));
  probe<BITS><<<blocks, threads>>>(16, out);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  probe<BITS><<<blocks, threads>>>(iters, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  const cudaError_t err = cudaGetLastError();
  const double mmas = (double)blocks * (threads / 32) * iters * CHAINS;
  const double ops = mmas * 16 * 8 * k_depth * 2;
  printf("%s: %s; %.4f ms, %.4g products/s, %.4g operations/s\n", name,
         cudaGetErrorString(err), ms, mmas / (ms * 1e-3),
         ops / (ms * 1e-3));
  cudaFree(out);
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s\n", prop.name);
#ifdef PROBE_B1
  run<1>("m16n8k256 b1 and.popc", 256);
#else
  run<8>("m16n8k32 s8", 32);
#endif
  return 0;
}
