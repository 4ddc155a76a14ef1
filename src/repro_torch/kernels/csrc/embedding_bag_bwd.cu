// The gradient of EmbeddingBag (embedding_bag.cu) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference trains Wide & Deep through its
// plain embedding_bag (models/recsys.py: jnp.take, then a sum or a mean)
// and takes the gradient by autodiff, and its Pallas kernel
// (kernels/embedding_bag.py embedding_bag_pallas) has no backward.  The
// port's bag fields run on the embedding_bag kernel, so training them
// needs its gradient.  With out[b] = sum over t of table[r(b, t)] / s,
// r(b, t) = clamp(ids[b, t], 0, V - 1), s = bag for the mean and 1 for
// the sum, and dout = dL/dout [B, E]:
//   dtable[v] = sum over (b, t) with r(b, t) = v, in (b, t) order, of
//               dout[b] / s                                     [V, E]
// dense, as the reference's autodiff of jnp.take gives it (AdamW decays
// every row, so a sparse gradient would change the update).  float32: the
// reference trains in float32; the wrapper refuses a bf16 table.
//
// Design.  Phase 15's skewed ids read 2.11 M distinct rows of 2.62 M
// lookups a field at B = 262,144, and the hottest rows hundreds of times:
// a float atomic a lookup would serialise on them and sum in an order
// that changes from run to run.  So the lookups are grouped by row
// (lane_groups.cuh: a counting sort built here, each group in (b, t)
// order, deterministic) and one warp a table row sums its group from zero
// (group_sum: the keys loaded 32 at once, 8 rows of dout in flight), each
// term dout[b] / bag rounded to nearest before its add, as the
// reference's mean transposes.  Rows no lookup reads get exact zeros.
// Bound on the H100: the dense dtable written once (4 V E bytes) and the
// distinct rows' dout terms read once; at phase 18's fields the write of
// dtable sets it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_groups.cuh"

namespace {

// lookup e of ids [B, bag] reads row clamp(id, 0, V - 1)
struct BagTarget {
  const int32_t* ids;
  int V;
  __device__ __forceinline__ int operator()(long long e) const {
    return min(max(ids[e], 0), V - 1);
  }
};

}  // namespace

// dtable [V, E] float32 from dout [B, E] float32 and ids [B, bag] int32.
// Scratch (int32): cnt and cursor [V], off [V + 1], bsum [scan_blocks(V)],
// lanes [4 B bag + 1], keys [B bag].  mean != 0 divides each term by bag.
extern "C" int repro_embedding_bag_bwd(const void* dout, const void* ids,
                                       void* dtable, void* cnt, void* cursor,
                                       void* off, void* bsum, void* lanes,
                                       void* keys, int B, int bag,
                                       long long V, int E, int mean,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long L = static_cast<long long>(B) * bag;
  if (L >= (1LL << 31) || V < 0 || V >= (1LL << 31) || E < 0 ||
      (L > 0 && V == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (V == 0 || E == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t e = group_lanes(
      BagTarget{static_cast<const int32_t*>(ids), static_cast<int>(V)}, L, V,
      static_cast<int*>(cnt), static_cast<int*>(cursor),
      static_cast<int*>(off), static_cast<int*>(bsum),
      static_cast<int*>(lanes), static_cast<int*>(keys), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  group_sum<<<sum_blocks(V), kSumWarps * 32, 0, st>>>(
      static_cast<const float*>(dout), static_cast<const int*>(keys),
      static_cast<const int*>(off), nullptr, static_cast<float*>(dtable), V,
      E, bag > 0 ? bag : 1, mean ? bag : 0);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local (spilled) bytes a thread of body `which`, in the
// order of kernels/embedding_bag.py BWD_BODIES.
extern "C" int repro_bag_bwd_attrs(int which, int* regs, int* local_bytes) {
  static const void* const bodies[] = {
      reinterpret_cast<const void*>(group_count<BagTarget>),
      reinterpret_cast<const void*>(scan_block_sums),
      reinterpret_cast<const void*>(scan_top),
      reinterpret_cast<const void*>(scan_down),
      reinterpret_cast<const void*>(group_fill<BagTarget>),
      reinterpret_cast<const void*>(group_order<BagTarget>),
      reinterpret_cast<const void*>(group_merge),
      reinterpret_cast<const void*>(group_sum)};
  constexpr int nb = sizeof(bodies) / sizeof(bodies[0]);
  if (which < 0 || which >= nb) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, bodies[which]);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
