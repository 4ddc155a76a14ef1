// EmbeddingBag for Hopper (sm_90a).
//
// Replaces the reference's TPU kernel kernels/embedding_bag.py
// embedding_bag_pallas (_bag_kernel): table [V, E] float32 or bf16, ids
// [B, bag] int32 -> out [B, E] in the table's type,
//   out[b] = sum over t = 0 .. bag-1 of table[ids[b, t]]   (sum)
//   out[b] = that sum / bag                                (mean)
// summed in fp32 in the order t = 0, 1, ... from zero, as the reference's
// body does (a bf16 row widened to fp32 first, its .astype(float32)), the
// mean a true division (__fdiv_rn), not a reciprocal multiply, and a bf16
// output rounded once, to nearest even, on the store.  The reference
// leaves ids outside [0, V) undefined; here they are clamped into the
// table, so the kernel never reads outside it.
//
// Bound: bytes.  Each lookup moves one row of E elements for E adds.  At
// wide_deep's bag fields (a 10,000,000 x 32 table, bag 10) and its
// training batch of 65,536 that is 84 MB of fp32 rows (42 MB in bf16) and
// 2.6 MB of ids in and 8.4 MB (4.2 MB) out, 0.028 ms (0.014 ms) at
// 3.35 TB/s, against 21 MFLOP.  The rows are random, so the time goes to
// the latency of the row reads, and what counts is how many are in
// flight.  Design: one warp per bag and 8 bags per CTA; the lanes span E,
// so a row of 32 elements is one coalesced load (128 bytes in fp32, 64 in
// bf16); a warp loads up to kBatch of its bag's ids and then issues all
// kBatch row loads before the first add, so kBatch independent misses are
// in flight per warp.  Row offsets are 64-bit: V * E can pass 2^31.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // bags per CTA
constexpr int kBatch = 16;   // row loads issued before the adds

// one element of the table, widened to fp32 (a bf16 element's bits are
// the top half of its float32)
template <typename T>
__device__ __forceinline__ float load_elem(const T* p);
template <>
__device__ __forceinline__ float load_elem<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float load_elem<uint16_t>(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(uint16_t* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// T: float (fp32 table) or uint16_t (a bf16 table's raw elements)
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
bag_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
           T* __restrict__ out, int B, int bag, long long V, int E,
           int mean) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const int32_t* bag_ids = ids + b * bag;
  T* orow = out + b * E;
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
          v[u] = load_elem(table + r * E + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (t0 + u < bag) acc += v[u];
      }
    }
    if (c < E)
      store_elem(orow + c,
                 mean ? __fdiv_rn(acc, static_cast<float>(bag)) : acc);
  }
}

template <typename T>
int launch(const void* table, const void* ids, void* out, int B, int bag,
           long long V, int E, int mean, cudaStream_t st) {
  const unsigned blocks =
      static_cast<unsigned>((B + (long long)kWarps - 1) / kWarps);
  bag_kernel<T><<<blocks, kWarps * 32, 0, st>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(ids),
      static_cast<T*>(out), B, bag, V, E, mean);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [V, E] float32 (bf16 = 0) or bf16 (bf16 = 1), ids [B, bag] int32
// -> out [B, E] in the table's type; mean != 0 divides the sum by bag.
extern "C" int repro_embedding_bag(const void* table, const void* ids,
                                   void* out, int B, int bag, long long V,
                                   int E, int mean, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || E == 0) return static_cast<int>(cudaGetLastError());
  return bf16 ? launch<uint16_t>(table, ids, out, B, bag, V, E, mean, st)
              : launch<float>(table, ids, out, B, bag, V, E, mean, st);
}

// Registers and local (spilled) bytes a thread of body `which`, in the
// order of kernels/embedding_bag.py BODIES: fp32, bf16.
extern "C" int repro_bag_attrs(int which, int* regs, int* local_bytes) {
  static const void* const bodies[] = {
      reinterpret_cast<const void*>(bag_kernel<float>),
      reinterpret_cast<const void*>(bag_kernel<uint16_t>)};
  if (which < 0 || which >= 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, bodies[which]);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
