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
// Design (lane_groups.cuh).  Phase 18's skewed ids read 608,744 distinct
// rows of a 10^7-row field with 655,360 lookups, the hottest rows
// hundreds of times: a float atomic a lookup would serialise on them and
// sum in an order that changes from run to run.  So the lookups (all
// valid: the ids are clamped) are sorted by row with a stable LSD radix
// sort read straight from the ids (3 passes of 8-bit digits at V = 10^7,
// one launch each), the runs of equal rows found, and each distinct row
// summed from zero over its lookups' dout[b] / bag in (b, t) order, each
// term rounded to nearest before its add (div_by), as the reference's
// mean transposes: a group of 8 lanes (a float4 of the row's 32 floats
// each) takes the rows that start in a block of 8 sorted lookups.  Then a
// store-only pass writes the zeros of the rows no lookup reads.  Every
// pass but the last follows the lookups, not V; no scratch is the size of
// the table.  Bound on the H100: the dense dtable written once (4 V E
// bytes) and dout and the ids read once; at phase 18's fields the write
// of dtable sets it, and the zero pass is most of the time (0.42 of 0.57
// ms of device time on an H100 80GB HBM3 at 700 W; PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_groups.cuh"

namespace {

// lookup e of ids [B, bag] adds dout[e / bag], divided by `div` for the
// mean
struct BagTerm {
  int bag;
  int div;
  __device__ __forceinline__ int src(int e) const { return e / bag; }
  __device__ __forceinline__ int div_of(int) const { return div; }
};

}  // namespace

// ints of scratch repro_bag_groups and repro_embedding_bag_bwd take for
// L = B bag lookups over V rows
extern "C" long long repro_bag_bwd_scratch(long long L, long long V) {
  return sort_scratch(L, V);
}

// The grouping of ids [B, bag] int32 over V rows: lanes [L] the lookups
// sorted by row, stably; rows [L] the distinct rows, starts [L + 1] their
// first positions, firsts [ceil(L / 8)] the row of every 8th position;
// meta [kMetaInts] the lookups and the distinct rows.
extern "C" int repro_bag_groups(const void* ids, void* lanes, void* rows,
                                void* starts, void* firsts, void* meta,
                                void* scratch, int B, int bag, long long V,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long L = static_cast<long long>(B) * bag;
  if (L >= (1LL << 31) || V < 1 || V >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(group_sort(
      IdsSrc{static_cast<const int32_t*>(ids), static_cast<int>(V)},
      Count{nullptr, L}, L, V, static_cast<int*>(scratch),
      static_cast<int*>(lanes), static_cast<int*>(rows),
      static_cast<int*>(starts), static_cast<int*>(firsts),
      static_cast<int*>(meta), st));
}

// dtable [V, E] float32 from dout [B, E] float32 and ids [B, bag] int32:
// the grouping (repro_bag_groups' outputs and scratch), the sum over the
// distinct rows, the zeros.  mean != 0 divides each term by bag.
extern "C" int repro_embedding_bag_bwd(const void* dout, const void* ids,
                                       void* dtable, void* lanes, void* rows,
                                       void* starts, void* firsts, void* meta,
                                       void* scratch, int B, int bag,
                                       long long V, int E, int mean,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long L = static_cast<long long>(B) * bag;
  if (L >= (1LL << 31) || V < 0 || V >= (1LL << 31) || E < 0 ||
      (L > 0 && V == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (V == 0 || E == 0) return static_cast<int>(cudaGetLastError());
  const int err = repro_bag_groups(ids, lanes, rows, starts, firsts, meta,
                                   scratch, B, bag, V, stream);
  if (err != 0) return err;
  return static_cast<int>(group_sum(
      static_cast<const float*>(dout), static_cast<const int*>(lanes),
      static_cast<const int*>(rows), static_cast<const int*>(starts),
      static_cast<const int*>(firsts), static_cast<const int*>(meta), L,
      BagTerm{bag > 0 ? bag : 1, bag}, mean != 0,
      static_cast<float*>(dtable), V, E, st));
}

// Registers and local (spilled) bytes a thread of body `which`, in the
// order of kernels/embedding_bag.py BWD_BODIES.
extern "C" int repro_bag_bwd_attrs(int which, int* regs, int* local_bytes) {
  static const void* const bodies[] = {
      reinterpret_cast<const void*>(radix_totals<IdsSrc>),
      reinterpret_cast<const void*>(radix_totals<PairSrc>),
      reinterpret_cast<const void*>(radix_onesweep<IdsSrc>),
      reinterpret_cast<const void*>(radix_onesweep<PairSrc>),
      reinterpret_cast<const void*>(scan_top),
      reinterpret_cast<const void*>(runs_count),
      reinterpret_cast<const void*>(runs_write),
      reinterpret_cast<const void*>(group_sum_vec<8, BagTerm>),
      reinterpret_cast<const void*>(group_sum_vec<32, BagTerm>),
      reinterpret_cast<const void*>(group_sum_scalar<BagTerm>),
      reinterpret_cast<const void*>(zero_unread<true>),
      reinterpret_cast<const void*>(zero_unread<false>)};
  constexpr int nb = sizeof(bodies) / sizeof(bodies[0]);
  if (which < 0 || which >= nb) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, bodies[which]);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
