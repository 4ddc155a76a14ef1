// Throughput and latency of the warp-level tensor-core instructions the
// port's attention kernel uses (mma.sync bf16 m16n8k16 and tf32 m16n8k8) on
// one card: where its tile body stands against what mma.sync can give.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o build/mma_sync_bench tools/mma_sync_bench.cu && build/mma_sync_bench
//
// Throughput: 528 CTAs of 4, 8 or 16 warps, each warp 8 independent
// accumulators, timed with CUDA events.  Latency: one warp, 1 to 8
// independent chains of dependent products, timed with clock64().
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

template <int KIND, int CH>  // KIND 0: bf16 m16n8k16, 1: tf32 m16n8k8
__global__ void chains(float* out, long long* cycles, int iters) {
  float c[CH][4] = {};
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
  const uint32_t b0 = 0x3f803f80u, b1 = threadIdx.x;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (KIND == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int j = 0; j < CH; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (blockIdx.x == 0 && threadIdx.x == 0) *cycles = t1 - t0;
}

template <int KIND>
void throughput(float* out, long long* cycles, int sms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int warps : {4, 8, 16}) {
    const int iters = 2000, ctas = 4 * sms;
    float ms = 0.f;
    for (int rep = 0; rep < 2; ++rep) {   // the first run warms up
      cudaEventRecord(e0);
      chains<KIND, 8><<<ctas, 32 * warps>>>(out, cycles, iters);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      cudaEventElapsedTime(&ms, e0, e1);
    }
    const double instr = 8.0 * ctas * warps * iters;
    const double flop = 2.0 * instr * (KIND == 0 ? 2048 : 1024);
    printf("throughput %s, %d warps a CTA: %.1f TFLOP/s, %.3f ns a product "
           "an SM\n", KIND ? "tf32 m16n8k8" : "bf16 m16n8k16", warps,
           flop / ms / 1e9, ms * 1e6 / (instr / sms));
  }
}

template <int KIND, int CH>
void latency(float* out, long long* cycles) {
  const int iters = 4096;
  long long c = 0;
  for (int rep = 0; rep < 2; ++rep) {
    chains<KIND, CH><<<1, 32>>>(out, cycles, iters);
    cudaMemcpy(&c, cycles, sizeof(c), cudaMemcpyDeviceToHost);
  }
  printf("latency %s, %d chains in one warp: %.1f clocks a step of a chain, "
         "%.1f a product\n", KIND ? "tf32 m16n8k8" : "bf16 m16n8k16", CH,
         double(c) / iters, double(c) / iters / CH);
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  long long* cycles;
  cudaMalloc(&out, sizeof(float) * 4 * sms * 512);
  cudaMalloc(&cycles, sizeof(long long));
  throughput<0>(out, cycles, sms);
  throughput<1>(out, cycles, sms);
  latency<0, 1>(out, cycles);
  latency<0, 4>(out, cycles);
  latency<0, 8>(out, cycles);
  latency<1, 1>(out, cycles);
  latency<1, 4>(out, cycles);
  latency<1, 8>(out, cycles);
  const cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    printf("error: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
