// EmbeddingBag for Hopper (sm_90a).
//
// Replaces the reference's TPU kernel kernels/embedding_bag.py
// embedding_bag_pallas (_bag_kernel): table [V, E] float32, ids [B, bag]
// int32 -> out [B, E] float32,
//   out[b] = sum over t = 0 .. bag-1 of table[ids[b, t]]   (sum)
//   out[b] = that sum / bag                                (mean)
// summed in fp32 in the order t = 0, 1, ... from zero, as the reference's
// body does, and the mean a true division (__fdiv_rn), not a reciprocal
// multiply.  The reference leaves ids outside [0, V) undefined; here they
// are clamped into the table, so the kernel never reads outside it.
//
// Bound: bytes.  Each lookup moves one row of E floats for E adds.  At
// wide_deep's bag fields (a 10,000,000 x 32 table, bag 10) and its
// training batch of 65,536 that is 84 MB of rows and 2.6 MB of ids in and
// 8.4 MB out, 0.028 ms at 3.35 TB/s, against 21 MFLOP.  The rows are
// random, so the time goes to the latency of the row reads, and what
// counts is how many are in flight.  Design: one warp per bag and 8 bags
// per CTA; the lanes span E, so a row of 32 floats is one coalesced
// 128-byte load; a warp loads up to kBatch of its bag's ids and then
// issues all kBatch row loads before the first add, so kBatch independent
// misses are in flight per warp.  Row offsets are 64-bit: V * E can pass
// 2^31.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // bags per CTA
constexpr int kBatch = 16;   // row loads issued before the adds

__global__ void __launch_bounds__(kWarps * 32)
bag_kernel(const float* __restrict__ table, const int32_t* __restrict__ ids,
           float* __restrict__ out, int B, int bag, long long V, int E,
           int mean) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const int32_t* bag_ids = ids + b * bag;
  float* orow = out + b * E;
  for (int c0 = 0; c0 < E; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.f;
    for (int t0 = 0; t0 < bag; t0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        v[u] = 0.f;
        if (t0 + u < bag && c < E) {
          long long r = __ldg(bag_ids + t0 + u);
          r = r < 0 ? 0 : (r >= V ? V - 1 : r);
          v[u] = __ldg(table + r * E + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (t0 + u < bag) acc += v[u];
      }
    }
    if (c < E) orow[c] = mean ? __fdiv_rn(acc, static_cast<float>(bag)) : acc;
  }
}

}  // namespace

// table [V, E] float32, ids [B, bag] int32 -> out [B, E] float32; mean != 0
// divides the sum by bag.
extern "C" int repro_embedding_bag(const void* table, const void* ids,
                                   void* out, int B, int bag, long long V,
                                   int E, int mean, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || E == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks =
      static_cast<unsigned>((B + (long long)kWarps - 1) / kWarps);
  bag_kernel<<<blocks, kWarps * 32, 0, st>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(ids),
      static_cast<float*>(out), B, bag, V, E, mean);
  return static_cast<int>(cudaGetLastError());
}
