// Bucketed open-addressing visited filter for Hopper (sm_90a).
//
// Replaces the reference's TPU kernel kernels/visited.py
// visited_filter_pallas (_vf_kernel, lane_step, hash_bucket): each row b
// owns a hash set table[b] of S buckets x W ways (int32, EMPTY = -1).
// Lanes are probed and inserted one after another, in the order given:
//   bucket = (uint32)(id * 0x9E3779B9) >> shift     (shift = 32 - log2 S)
//   hit    = some way of the bucket holds id
//   fresh  = valid and not hit and the bucket has an empty way,
// and a fresh id goes into the bucket's first empty way.
//
// Layout: bucket-major [B, S, W], where the reference's is [B, W, S] (its
// probe runs along the TPU's lanes).  A bucket's W = 8 ways are one
// 32-byte sector, read by one lane as two 16-byte loads; in the
// reference's layout they lie S * 4 bytes apart, 8 sectors a probe.  The
// update is IN PLACE: the large regime's table is [10240, 2048, 8] int32
// = 671 MB, and the caller never reads the old table again.
//
// Bound: memory, latency-dominated.  A lane reads one bucket (W * 4 bytes)
// and writes at most one word.  Design: one warp a row, one lane a lane of
// the call, 32 at a time.  Every lane loads its own id and its whole
// bucket at once, so the probes of 32 lanes are one round trip; the lane
// order of the definition is then resolved in registers.  Lanes whose ids
// share a bucket form a group (__match_any_sync); since a bucket only
// gains ids, the sequential outcome has a closed form over the bucket as
// loaded:
//   * a lane whose id an earlier lane of the group holds is never fresh
//     (the earlier one hit, was inserted, or found the bucket full, which
//     it stays);
//   * a first occurrence is a hit if the loaded bucket holds its id;
//   * else it is the k-th first-occurrence miss of its group (k counted
//     over lower lanes), fresh if the bucket had more than k empty ways,
//     and it takes the k-th empty way.
// Fresh lanes then store their word.  Calls of more than 32 lanes go in
// chunks of 32, in order, a __syncwarp between them, so each chunk loads
// the buckets as the previous one left them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWays = 8;
constexpr unsigned kFull = 0xffffffffu;

// The W ways of one bucket into w[0, W) (0 past W): the bucket's sector
// as two 16-byte loads when W = 8 and the table is 16-byte aligned (VEC),
// else word by word.  Plain (coherent) loads: an earlier chunk of this
// warp may have written the bucket.
template <bool VEC>
__device__ __forceinline__ void load_bucket(const int32_t* p, int W,
                                            int32_t (&w)[kMaxWays]) {
  if constexpr (VEC) {
    const int4 a = reinterpret_cast<const int4*>(p)[0];
    const int4 b = reinterpret_cast<const int4*>(p)[1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kMaxWays; ++k) w[k] = k < W ? p[k] : 0;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
visited_filter_kernel(int32_t* table, const int32_t* __restrict__ ids,
                      const uint8_t* __restrict__ valid,
                      uint8_t* __restrict__ fresh, int B, int W, int S,
                      int M, int shift) {
  const long long b =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;   // warp-uniform
  const unsigned below = (1u << lane) - 1u;
  int32_t* tab = table + b * static_cast<long long>(S) * W;
  for (int m0 = 0; m0 < M; m0 += 32) {
    const long long l = b * M + m0 + lane;
    const bool in = m0 + lane < M;
    const int32_t lid = in ? ids[l] : 0;
    const bool lval = in && valid[l] != 0;
    const uint32_t bucket =
        (static_cast<uint32_t>(lid) * 0x9E3779B9u) >> shift;
    int32_t w[kMaxWays] = {};
    int32_t* bp = tab + static_cast<long long>(bucket) * W;
    if (lval) load_bucket<VEC>(bp, W, w);
    // groups of valid lanes on one bucket, and of one id; an invalid
    // lane is a group of its own (buckets are < 2^31)
    const unsigned grp =
        __match_any_sync(kFull, lval ? bucket : 0x80000000u | lane);
    const unsigned same = __match_any_sync(kFull, lid) & grp;
    const bool first = lval && (same & below) == 0u;
    bool hit = false;
    int n_empty = 0;
#pragma unroll
    for (int k = 0; k < kMaxWays; ++k) {
      hit |= k < W && w[k] == lid;
      n_empty += k < W && w[k] == -1;
    }
    const bool miss = first && !hit;
    const int rank = __popc(__ballot_sync(kFull, miss) & grp & below);
    const bool f = miss && rank < n_empty;
    if (f) {   // the rank-th empty way
      int slot = 0;
#pragma unroll
      for (int k = 0, e = 0; k < kMaxWays; ++k) {
        const bool empty = k < W && w[k] == -1;
        if (empty && e == rank) slot = k;
        e += empty;
      }
      bp[slot] = lid;
    }
    if (in) fresh[l] = f ? 1 : 0;
    __syncwarp();   // this chunk's stores before the next chunk's loads
  }
}

}  // namespace

extern "C" int repro_visited_filter(void* table, const void* ids,
                                    const void* valid, void* fresh, int B,
                                    int W, int S, int M, int shift,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W < 1 || W > kMaxWays) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || M == 0) return static_cast<int>(cudaGetLastError());
  const long long threads = static_cast<long long>(B) * 32;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  const bool vec =
      W == kMaxWays && reinterpret_cast<uintptr_t>(table) % 16 == 0;
  auto kern = vec ? visited_filter_kernel<true> : visited_filter_kernel<false>;
  kern<<<blocks, kThreads, 0, st>>>(
      static_cast<int32_t*>(table), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(fresh), B, W,
      S, M, shift);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local (spilled) bytes a thread of each body, in the order
// of kernels/visited.py BODIES: two 16-byte loads a bucket, then word by
// word.
extern "C" int repro_visited_attrs(int which, int* regs, int* local_bytes) {
  static const void* const bodies[] = {
      reinterpret_cast<const void*>(visited_filter_kernel<true>),
      reinterpret_cast<const void*>(visited_filter_kernel<false>)};
  if (which < 0 || which >= 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, bodies[which]);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
