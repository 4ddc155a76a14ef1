// Bucketed open-addressing visited filter for Hopper (sm_90a).
//
// Replaces the reference's TPU kernel kernels/visited.py
// visited_filter_pallas (_vf_kernel, lane_step, hash_bucket): each row b
// owns a hash set table[b] of W ways x S buckets (int32, EMPTY = -1).
// Lanes are probed and inserted one after another, in the order given:
//   bucket = (uint32)(id * 0x9E3779B9) >> shift     (shift = 32 - log2 S)
//   hit    = some way of the bucket holds id
//   fresh  = valid and not hit and the bucket has an empty way,
// and a fresh id goes into the bucket's first empty way.
//
// The update is IN PLACE: the large regime's table is [10240, 8, 2048]
// int32 = 671 MB, and the caller never reads the old table again, so the
// kernel touches only the probed buckets instead of copying the table.
//
// Bound: memory, latency-dominated.  Each lane reads one W-way bucket
// (W * 4 bytes, one per way in separate rows of the table) and writes at
// most one word; lanes of a row are sequential by definition.  Design: one
// warp per row, lane w of the warp holds way w of the probed bucket, so a
// probe is one load per lane plus two ballots, and rows run in parallel
// across warps.  __syncwarp orders each insertion before the next probe.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
visited_filter_kernel(int32_t* table, const int32_t* __restrict__ ids,
                      const uint8_t* __restrict__ valid,
                      uint8_t* __restrict__ fresh, int B, int W, int S,
                      int M, int shift) {
  const long long b =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  int32_t* tab = table + b * W * S;
  for (int m = 0; m < M; ++m) {
    const long long l = b * M + m;
    const int32_t lid = ids[l];
    const bool lval = valid[l] != 0;
    const uint32_t bucket =
        (static_cast<uint32_t>(lid) * 0x9E3779B9u) >> shift;
    const bool way = lane < W;
    const int32_t v = way ? tab[(long long)lane * S + bucket] : 0;
    const unsigned hit = __ballot_sync(0xffffffffu, way && v == lid);
    const unsigned emp = __ballot_sync(0xffffffffu, way && v == -1);
    const bool f = lval && hit == 0u && emp != 0u;
    if (f && lane == __ffs(emp) - 1) tab[(long long)lane * S + bucket] = lid;
    if (lane == 0) fresh[l] = f ? 1 : 0;
    __syncwarp();
  }
}

}  // namespace

extern "C" int repro_visited_filter(void* table, const void* ids,
                                    const void* valid, void* fresh, int B,
                                    int W, int S, int M, int shift,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const long long threads = static_cast<long long>(B) * 32;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  visited_filter_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<int32_t*>(table), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(fresh), B, W,
      S, M, shift);
  return static_cast<int>(cudaGetLastError());
}
