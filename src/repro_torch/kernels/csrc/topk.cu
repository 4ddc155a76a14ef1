// Row-wise (dist, id) top-k and sort for Hopper (sm_90a).
//
// Replaces the reference's TPU kernels kernels/topk.py rank_merge_pallas
// (_bitonic_network, _sort_kernel, _masked_sort_kernel) and
// bitonic_sort_pallas / bitonic_topk_pallas, which share that network.
// Each row of (dists [R, W], ids [R, W]) is ordered ascending by
//   a before b  <=>  a_d < b_d  or  (a_d == b_d and a_i < b_i),
// so -0.0 and +0.0 tie and break on id, as lexsort((ids, dists)) does;
// masked lanes carry dist 3.4e38 and keep their ids; the first `keep`
// lanes are written with the inputs' own float values.  Lanes past the
// row's end are (+inf, 2^31 - 1): they follow every real lane, or equal
// it bit for bit, so they are never written in place of one (the
// reference pads with 3.4e38, which only differs for dists above it).
//
// Bound: the bytes (R * W * 8 in, plus the mask, R * keep * 8 out); a
// selection needs one compare a lane, a sort W log2 W, far below them.
// Three kernels over two designs, chosen by kernels/topk.py::plan:
//
//  * warp_select<P>, the core of two kernels: a warp keeps a sorted queue
//    of Q = 32 * P (dist, id) pairs in registers, P a lane (virtual index
//    lane * P + r), and walks its columns in chunks of Q lanes, loaded
//    coalesced (up to Q = 256 the next chunk is in flight while this one
//    merges).  A chunk enters only if one of its lanes beats the queue's
//    keep-th key (a compare and a warp vote, so most lanes cost one
//    compare).  Up to 16 entering lanes are inserted one at a time;
//    more, and the chunk is bitonic-sorted descending and folded in by an
//    element-wise min and a bitonic merge.  Strides below P are exchanged
//    inside a thread, larger ones through __shfl_xor_sync: no shared
//    memory and no barrier.
//    - warp_topk_kernel<P>: one warp a row of up to 1,024 lanes, 8 rows a
//      CTA (a row no wider than Q is one chunk: a full sort).
//    - select_kernel<P>: the one-pass selection of rows wider than that
//      (keep <= 256).  G CTAs of 8 warps a row, each warp a column slice;
//      the warps leave their queues in shared memory and warp 0 merges
//      them.  With G > 1 a warp_topk launch merges the G queues.
//  * cta_sort_kernel: full sorts of 2,048 to 16,384 lanes, one CTA a row,
//    32 pairs a thread.  Strides below 32 run in registers, strides below
//    1,024 through shuffles, and only the wider ones through shared
//    memory (8 * Wp bytes, swizzled against bank conflicts) with two
//    barriers each: 10 of the 105 stages at 16,384 lanes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaskDist = 3.4e38f;
constexpr int32_t kPadId = 2147483647;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;            // warps of a warp_topk CTA
constexpr int kCtaP = 32;            // pairs a thread in cta_sort

__device__ __forceinline__ float pad_dist() {
  return __int_as_float(0x7f800000);   // +inf
}

__device__ __forceinline__ bool less(float ad, int32_t ai, float bd,
                                     int32_t bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// Lane c of row `base` (c < hi), or a pad past the end.
__device__ __forceinline__ void load_lane(const float* __restrict__ dists,
                                          const int32_t* __restrict__ ids,
                                          const uint8_t* __restrict__ mask,
                                          long long base, int c, int hi,
                                          float& d, int32_t& i) {
  if (c < hi) {
    const long long l = base + c;
    d = (mask == nullptr || __ldg(mask + l) != 0) ? __ldg(dists + l)
                                                   : kMaskDist;
    i = __ldg(ids + l);
  } else {
    d = pad_dist();
    i = kPadId;
  }
}

// Compare-exchange of the pair (a lower, b upper): after it a holds the
// smaller key when `asc`, the larger otherwise.
__device__ __forceinline__ void cx(float& ad, int32_t& ai, float& bd,
                                   int32_t& bi, bool asc) {
  const bool sw = asc ? less(bd, bi, ad, ai) : less(ad, ai, bd, bi);
  const float td = sw ? bd : ad, ud = sw ? ad : bd;
  const int32_t ti = sw ? bi : ai, ui = sw ? ai : bi;
  ad = td; bd = ud; ai = ti; bi = ui;
}

// Every in-thread stage (stride J < P) of bitonic phase k.  The thread
// holds virtual indices vbase .. vbase + P - 1; a pair ascends where bit k
// of its index is clear, descends otherwise, all flipped by `desc`.
template <int P>
__device__ __forceinline__ void local_stages(float (&d)[P], int32_t (&id)[P],
                                             int vbase, int k, bool desc) {
#pragma unroll
  for (int J = P >> 1; J > 0; J >>= 1) {
    if (J < k) {
#pragma unroll
      for (int r = 0; r < P; ++r) {
        if (r & J) continue;
        const bool asc = (((vbase + r) & k) == 0) != desc;
        cx(d[r], id[r], d[r + J], id[r + J], asc);
      }
    }
  }
}

// One stage of stride j (P <= j < 32 P): the partner is lane ^ (j / P).
template <int P>
__device__ __forceinline__ void shfl_stage(float (&d)[P], int32_t (&id)[P],
                                           int vbase, int k, int j,
                                           bool desc) {
  const int m = j / P;
  const bool asc = ((vbase & k) == 0) != desc;
  const bool take_min = ((vbase & j) == 0) == asc;
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const float pd = __shfl_xor_sync(kFull, d[r], m);
    const int32_t pi = __shfl_xor_sync(kFull, id[r], m);
    const bool sw = take_min ? less(pd, pi, d[r], id[r])
                             : less(d[r], id[r], pd, pi);
    d[r] = sw ? pd : d[r];
    id[r] = sw ? pi : id[r];
  }
}

// Bitonic sort of the warp's 32 * P pairs, ascending (descending if desc).
template <int P>
__device__ __forceinline__ void warp_sort(float (&d)[P], int32_t (&id)[P],
                                          int vbase, bool desc) {
  for (int k = 2; k <= 32 * P; k <<= 1) {
    for (int j = k >> 1; j >= P; j >>= 1)
      shfl_stage<P>(d, id, vbase, k, j, desc);
    local_stages<P>(d, id, vbase, k, desc);
  }
}

// Bitonic merge of a bitonic sequence of 32 * P pairs into ascending order.
template <int P>
__device__ __forceinline__ void warp_merge(float (&d)[P], int32_t (&id)[P],
                                           int vbase) {
  constexpr int kAll = 64 * P;   // bit never set: every pair ascends
  for (int j = 16 * P; j >= P; j >>= 1)
    shfl_stage<P>(d, id, vbase, kAll, j, false);
  local_stages<P>(d, id, vbase, kAll, false);
}

// Where a warp reads its lanes: a row in device memory (with its mask) ...
struct GlobalRow {
  const float* __restrict__ dists;
  const int32_t* __restrict__ ids;
  const uint8_t* __restrict__ mask;
  long long base;
  __device__ __forceinline__ void operator()(int c, int hi, float& d,
                                             int32_t& i) const {
    load_lane(dists, ids, mask, base, c, hi, d, i);
  }
};

// ... or the queues a CTA's warps left in shared memory.
struct SharedRow {
  const float* d;
  const int32_t* i;
  __device__ __forceinline__ void operator()(int c, int hi, float& od,
                                             int32_t& oi) const {
    od = c < hi ? d[c] : pad_dist();
    oi = c < hi ? i[c] : kPadId;
  }
};

// Lane r * 32 + lane of the chunk starting at column c, into register r.
template <int P, class Src>
__device__ __forceinline__ void load_chunk(const Src& src, int c, int hi,
                                           int lane, float (&d)[P],
                                           int32_t (&id)[P]) {
#pragma unroll
  for (int r = 0; r < P; ++r) src(c + r * 32 + lane, hi, d[r], id[r]);
}

// The queue's key at virtual index t, on every lane.
template <int P>
__device__ __forceinline__ void key_at(const float (&d)[P],
                                       const int32_t (&id)[P], int t,
                                       float& kd, int32_t& ki) {
  const int rr = t % P;
  kd = d[0];
  ki = id[0];
#pragma unroll
  for (int r = 1; r < P; ++r) {
    if (r == rr) { kd = d[r]; ki = id[r]; }
  }
  kd = __shfl_sync(kFull, kd, t / P);
  ki = __shfl_sync(kFull, ki, t / P);
}

// Insert x into the sorted queue at its place; the last pair drops out.
template <int P>
__device__ __forceinline__ void insert(float (&d)[P], int32_t (&id)[P],
                                       float xd, int32_t xi, int vbase) {
  int below = 0;
#pragma unroll
  for (int r = 0; r < P; ++r) below += !less(xd, xi, d[r], id[r]);
  const int pos = __reduce_add_sync(kFull, below);
  const float ud = __shfl_up_sync(kFull, d[P - 1], 1);
  const int32_t ui = __shfl_up_sync(kFull, id[P - 1], 1);
  // each pair above pos takes its predecessor's (the top one drops out)
#pragma unroll
  for (int r = P - 1; r > 0; --r) {
    if (vbase + r == pos) { d[r] = xd; id[r] = xi; }
    else if (vbase + r > pos) { d[r] = d[r - 1]; id[r] = id[r - 1]; }
  }
  if (vbase == pos) { d[0] = xd; id[0] = xi; }
  else if (vbase > pos) { d[0] = ud; id[0] = ui; }
}

// A chunk whose entering lanes are at most this many inserts them one at
// a time (a vote, a sum and a shift each) instead of sorting the chunk.
constexpr int kInsertMax = 16;

// The warp's best `keep` of columns [lo, hi) of src, ascending in the
// queue (qd, qi): virtual index lane * P + r, the first keep exact.
template <int P, class Src>
__device__ __forceinline__ void warp_select(const Src& src, int lo, int hi,
                                            int keep, int lane,
                                            float (&qd)[P],
                                            int32_t (&qi)[P]) {
  constexpr int Q = 32 * P;
  const int vbase = lane * P;
  load_chunk<P>(src, lo, hi, lane, qd, qi);
  warp_sort<P>(qd, qi, vbase, false);
  if (lo + Q >= hi) return;
  float td;
  int32_t ti;
  key_at<P>(qd, qi, keep - 1, td, ti);
  // up to 8 pairs a lane the next chunk is in flight while this one
  // merges, and few entering lanes are inserted; wider queues (rows of at
  // most 1,024 lanes, two chunks) would spill the registers either needs
  constexpr bool kAhead = P <= 8, kInsert = P <= 8;
  float nd[P];
  int32_t ni[P];
  if (kAhead) load_chunk<P>(src, lo + Q, hi, lane, nd, ni);
  for (int c = lo + Q; c < hi; c += Q) {
    float cd[P];
    int32_t ci[P];
    if constexpr (kAhead) {
#pragma unroll
      for (int r = 0; r < P; ++r) { cd[r] = nd[r]; ci[r] = ni[r]; }
      if (c + Q < hi) load_chunk<P>(src, c + Q, hi, lane, nd, ni);
    } else {
      load_chunk<P>(src, c, hi, lane, cd, ci);
    }
    unsigned enter[P];
    int n_enter = 0;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      enter[r] = __ballot_sync(kFull, less(cd[r], ci[r], td, ti));
      n_enter += __popc(enter[r]);
    }
    if (n_enter == 0) continue;
    if (kInsert && n_enter <= kInsertMax) {
#pragma unroll
      for (int r = 0; r < P; ++r) {
        for (unsigned m = enter[r]; m != 0; m &= m - 1) {
          const int src_lane = __ffs(m) - 1;
          insert<P>(qd, qi, __shfl_sync(kFull, cd[r], src_lane),
                    __shfl_sync(kFull, ci[r], src_lane), vbase);
        }
      }
    } else {
      // queue ascending, chunk descending: their element-wise min is a
      // bitonic sequence holding the best Q of both
      warp_sort<P>(cd, ci, vbase, true);
#pragma unroll
      for (int r = 0; r < P; ++r) {
        if (less(cd[r], ci[r], qd[r], qi[r])) {
          qd[r] = cd[r];
          qi[r] = ci[r];
        }
      }
      warp_merge<P>(qd, qi, vbase);
    }
    key_at<P>(qd, qi, keep - 1, td, ti);
  }
}

// One warp a row of W <= 1,024 lanes: the best `keep`, ascending.
template <int P>
__global__ void __launch_bounds__(kWarps * 32)
warp_topk_kernel(const float* __restrict__ dists,
                 const int32_t* __restrict__ ids,
                 const uint8_t* __restrict__ mask, float* __restrict__ od,
                 int32_t* __restrict__ oi, int R, int W, int keep) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;                                  // the whole warp
  float qd[P];
  int32_t qi[P];
  warp_select<P>(GlobalRow{dists, ids, mask, row * (long long)W}, 0, W, keep,
                 lane, qd, qi);
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int v = lane * P + r;
    if (v < keep) { od[row * keep + v] = qd[r]; oi[row * keep + v] = qi[r]; }
  }
}

// The selection: CTA (row, g) of G a row; its 8 warps take slices
// g * 8 + w of `slice` columns, leave their best `keep` in shared memory,
// and warp 0 merges those 8 * keep into od/oi[row, g * keep ...) (rows of
// G * keep, merged again by a warp_topk launch when G > 1).
template <int P>
__global__ void __launch_bounds__(kWarps * 32)
select_kernel(const float* __restrict__ dists,
              const int32_t* __restrict__ ids,
              const uint8_t* __restrict__ mask, float* __restrict__ od,
              int32_t* __restrict__ oi, int W, int keep, int slice, int G) {
  __shared__ float sd[kWarps * 32 * P];
  __shared__ int32_t si[kWarps * 32 * P];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long row = blockIdx.x / G;
  const int g = static_cast<int>(blockIdx.x - row * G);
  const int lo = min(W, (g * kWarps + w) * slice);
  float qd[P];
  int32_t qi[P];
  warp_select<P>(GlobalRow{dists, ids, mask, row * (long long)W}, lo,
                 min(W, lo + slice), keep, lane, qd, qi);
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int v = lane * P + r;
    if (v < keep) { sd[w * keep + v] = qd[r]; si[w * keep + v] = qi[r]; }
  }
  __syncthreads();
  if (w != 0) return;
  warp_select<P>(SharedRow{sd, si}, 0, kWarps * keep, keep, lane, qd, qi);
  const long long o = (row * G + g) * (long long)keep;
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int v = lane * P + r;
    if (v < keep) { od[o + v] = qd[r]; oi[o + v] = qi[r]; }
  }
}

// Shared-memory slot of virtual index v: rows of 32 words rotated by the
// row, so a warp's 32 threads (v = 32 t + r, r fixed) hit 32 banks.
__device__ __forceinline__ int swz(int v) { return v ^ ((v >> 5) & 31); }

// One CTA of Wp / 32 threads per row: the full bitonic sort of Wp lanes,
// the first `keep` written.
__global__ void __launch_bounds__(512)
cta_sort_kernel(const float* __restrict__ dists,
                const int32_t* __restrict__ ids,
                const uint8_t* __restrict__ mask, float* __restrict__ od,
                int32_t* __restrict__ oi, int W, int Wp, int keep) {
  constexpr int P = kCtaP;
  extern __shared__ unsigned char smem[];
  float* sd = reinterpret_cast<float*>(smem);
  int32_t* si = reinterpret_cast<int32_t*>(sd + Wp);
  const long long row = blockIdx.x;
  const int t = threadIdx.x, T = blockDim.x;
  const long long base = row * (long long)W;
  const int vbase = t * P;
  float d[P];
  int32_t id[P];
#pragma unroll
  for (int r = 0; r < P; ++r)          // coalesced: column r * T + t
    load_lane(dists, ids, mask, base, r * T + t, W, d[r], id[r]);
  for (int k = 2; k <= Wp; k <<= 1) {
    for (int j = k >> 1; j >= 32 * P; j >>= 1) {
      __syncthreads();                 // the last stage's reads are done
#pragma unroll
      for (int r = 0; r < P; ++r) {
        sd[swz(vbase + r)] = d[r];
        si[swz(vbase + r)] = id[r];
      }
      __syncthreads();
      const bool asc = (vbase & k) == 0;
      const bool take_min = ((vbase & j) == 0) == asc;
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const int p = swz((vbase + r) ^ j);
        const float pd = sd[p];
        const int32_t pi = si[p];
        const bool sw = take_min ? less(pd, pi, d[r], id[r])
                                 : less(d[r], id[r], pd, pi);
        d[r] = sw ? pd : d[r];
        id[r] = sw ? pi : id[r];
      }
    }
    for (int j = min(k >> 1, 16 * P); j >= P; j >>= 1)
      shfl_stage<P>(d, id, vbase, k, j, false);
    local_stages<P>(d, id, vbase, k, false);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < P; ++r) {
    sd[swz(vbase + r)] = d[r];
    si[swz(vbase + r)] = id[r];
  }
  __syncthreads();
  const long long o = row * (long long)keep;
  for (int v = t; v < keep; v += T) {
    od[o + v] = sd[swz(v)];
    oi[o + v] = si[swz(v)];
  }
}

template <int P>
int launch_warp(const void* dists, const void* ids, const void* mask,
                void* od, void* oi, int R, int W, int keep, int slice,
                int G, cudaStream_t st) {
  const float* d = static_cast<const float*>(dists);
  const int32_t* i = static_cast<const int32_t*>(ids);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (slice == 0) {
    warp_topk_kernel<P><<<(R + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
        d, i, m, static_cast<float*>(od), static_cast<int32_t*>(oi), R, W,
        keep);
  } else if constexpr (P <= 8) {   // the selection keeps at most 256
    select_kernel<P><<<static_cast<unsigned>((long long)R * G), kWarps * 32,
                       0, st>>>(d, i, m, static_cast<float*>(od),
                                static_cast<int32_t*>(oi), W, keep, slice,
                                G);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The warp body, queue width q = 32 * P (P = 1, 2, ..., 32), keep <= q:
// with slice == 0 one warp a row; else the selection, G CTAs a row of 8
// warps taking `slice` columns each (q <= 256).
extern "C" int repro_topk_warp(const void* dists, const void* ids,
                               const void* mask, void* od, void* oi, int R,
                               int W, int keep, int q, int slice, int G,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_TOPK_WARP(P) \
  launch_warp<P>(dists, ids, mask, od, oi, R, W, keep, slice, G, st)
  switch (q) {
    case 32: return REPRO_TOPK_WARP(1);
    case 64: return REPRO_TOPK_WARP(2);
    case 128: return REPRO_TOPK_WARP(4);
    case 256: return REPRO_TOPK_WARP(8);
    case 512: return REPRO_TOPK_WARP(16);
    case 1024: return REPRO_TOPK_WARP(32);
#undef REPRO_TOPK_WARP
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Full sort of rows padded to Wp (a power of two, 2,048 to 16,384).
extern "C" int repro_topk_cta(const void* dists, const void* ids,
                              const void* mask, void* od, void* oi, int R,
                              int W, int Wp, int keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Wp < 64 * kCtaP || Wp > 512 * kCtaP || (Wp & (Wp - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kPairBytes = sizeof(float) + sizeof(int32_t);
  // above 48 KB only once raised, here once to the widest row's 128 KB
  static const cudaError_t raised = cudaFuncSetAttribute(
      cta_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      512 * kCtaP * kPairBytes);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  cta_sort_kernel<<<R, Wp / kCtaP, Wp * kPairBytes, st>>>(
      static_cast<const float*>(dists), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(mask), static_cast<float*>(od),
      static_cast<int32_t*>(oi), W, Wp, keep);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local (spilled) bytes a thread of each kernel: which =
// 0..5 warp_topk_kernel with P = 1 << which, 6..9 select_kernel with
// P = 1 << (which - 6), 10 cta_sort_kernel.
extern "C" int repro_topk_attrs(int which, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e;
  switch (which) {
    case 0: e = cudaFuncGetAttributes(&a, warp_topk_kernel<1>); break;
    case 1: e = cudaFuncGetAttributes(&a, warp_topk_kernel<2>); break;
    case 2: e = cudaFuncGetAttributes(&a, warp_topk_kernel<4>); break;
    case 3: e = cudaFuncGetAttributes(&a, warp_topk_kernel<8>); break;
    case 4: e = cudaFuncGetAttributes(&a, warp_topk_kernel<16>); break;
    case 5: e = cudaFuncGetAttributes(&a, warp_topk_kernel<32>); break;
    case 6: e = cudaFuncGetAttributes(&a, select_kernel<1>); break;
    case 7: e = cudaFuncGetAttributes(&a, select_kernel<2>); break;
    case 8: e = cudaFuncGetAttributes(&a, select_kernel<4>); break;
    case 9: e = cudaFuncGetAttributes(&a, select_kernel<8>); break;
    case 10: e = cudaFuncGetAttributes(&a, cta_sort_kernel); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
