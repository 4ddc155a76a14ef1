// The gradient of packed SpMM (segment_matmul.cu) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference trains GraphSAGE through its plain
// segment_sum and takes the gradient by autodiff, and its Pallas kernel
// (kernels/segment_matmul.py packed_spmm_pallas) has no backward.  The
// port's GraphSAGE runs its neighbour mean on the packed_spmm kernel, so
// training it needs the kernel's gradient.  With
//   out[i] = agg[i] @ W,  agg[i] = sum over valid lanes m of
//            feat[max(nbrs[i, m], 0)] / c_i
// (a lane is valid when its id is below Nf; c_i = 1 for the sum, max(the
// valid lanes, 1) for the mean) and dout = dL/dout [N, f]:
//   dfeat[j] = sum over valid lanes (i, m) with max(nbrs[i, m], 0) = j,
//              in (i, m) order, of G[i] / c_i,   G = dout @ W^T   [Nf, d]
//   dW       = agg^T @ dout                                        [d, f]
// and no gradient for nbrs.  float32 throughout (the reference trains in
// float32); the wrapper refuses bf16 operands.  Only the active rows, those
// with a valid lane, take part: a row with none has agg = 0 and no term.
//
// The launches (kernels/segment_matmul.py):
//   * the plan, once a neighbour matrix (repro_spmm_plan; lane_groups.cuh):
//     the valid lanes compacted in lane order with each row's count and
//     the active rows, then sorted by the row they read (a stable LSD
//     radix sort, 3 passes of 6-bit digits at Nf = 169,984) and cut into
//     runs of distinct rows.  GraphSAGE's two layers share one plan.
//   * G_a = dout[active] @ W^T: segment_matmul.cu's copy of the active
//     rows and its project_kernel (the 3xTF32 tile, a row of G from that
//     row of dout alone), W^T made contiguous by the wrapper.
//   * repro_spmm_bwd_dfeat: a group of lanes a distinct feat row sums
//     G_a[rank(i)] / c_i over its sorted lanes from zero (div_by), then a
//     store-only pass writes the zeros of the rows no lane reads: at
//     minibatch_lg 168,960 of 169,984 rows are read once and 90% of rows
//     have no child.
//   * agg: segment_matmul.cu's gather_kernel over the active rows (the
//     forward's lane-order sum and __fdiv_rn mean).
//   * repro_spmm_bwd_dw: dw_partial_kernel, a [64, 64] tile of dW a CTA
//     over one of S splits of the active rows, in order, FFMA; then
//     dw_reduce_kernel sums the S partials in split order.  No atomics, so
//     a repeat is bit for bit.
// Bound on the H100: dfeat reads G's rows once a lane (4 d bytes) and
// writes dfeat once (4 Nf d); dW's 2 R d f operations over the R active
// rows at the TF32 rate (495 TFLOP/s), which FFMA at 67 cannot reach; at
// minibatch_lg the dense dfeat write and the launches set the time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_groups.cuh"

namespace {

// lane e of nbrs [N, M] reads row max(id, 0) of feat, or none (id >= Nf)
struct SpmmTarget {
  const int32_t* nbrs;
  int Nf;
  __device__ __forceinline__ int operator()(long long e) const {
    const int id = nbrs[e];
    return id < Nf ? max(id, 0) : -1;
  }
};

// lane e = (i, m) adds row rank[i] of G_a, divided by c_i for the mean
struct SpmmTerm {
  int M;
  const int* rank;
  const int* counts;
  __device__ __forceinline__ int src(int e) const { return rank[e / M]; }
  __device__ __forceinline__ int div_of(int e) const { return counts[e / M]; }
};

constexpr int kWT = 64;        // rows of d and columns of f a dW tile
constexpr int kWRows = 32;     // rows of agg and dout staged at once
constexpr int kWThreads = 256; // 16 x 16, a 4 x 4 block of the tile each

// part[s] [d, f] = sum over the active rows k of split s (of gridDim.x
// even splits of the count), in order, of agg_a[k]^T dout[active[k]] (or
// dout[k], where active is null: dout's active rows copied together), for
// the tile (blockIdx.y, blockIdx.z)
__global__ void __launch_bounds__(kWThreads)
dw_partial_kernel(const float* __restrict__ agg,
                  const float* __restrict__ dout,
                  const int* __restrict__ active, Count count,
                  float* __restrict__ part, int d, int f) {
  __shared__ __align__(16) float as[kWRows][kWT];
  __shared__ __align__(16) float bs[kWRows][kWT];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const long long n = count.get();
  const long long per = (n + gridDim.x - 1) / gridDim.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * per;
  const long long r1 = min(n, r0 + per);
  const int d0 = blockIdx.y * kWT, f0 = blockIdx.z * kWT;
  float acc[4][4] = {};
  for (long long k0 = r0; k0 < r1; k0 += kWRows) {
    const int nn = static_cast<int>(min(static_cast<long long>(kWRows),
                                        r1 - k0));
    for (int e = tid; e < kWRows * kWT; e += kWThreads) {
      const int rr = e / kWT, cc = e - rr * kWT;
      const bool ok = rr < nn;
      const long long k = k0 + rr;
      as[rr][cc] = ok && d0 + cc < d ? agg[k * d + d0 + cc] : 0.f;
      bs[rr][cc] = ok && f0 + cc < f
                       ? dout[(active != nullptr ? active[k] : k) * f + f0 +
                              cc]
                       : 0.f;
    }
    __syncthreads();
    for (int rr = 0; rr < nn; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&as[rr][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[rr][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
    }
    __syncthreads();
  }
  float* p = part + static_cast<long long>(blockIdx.x) * d * f;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int row = d0 + 4 * ty + x;
    if (row >= d) continue;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int col = f0 + 4 * tx + y;
      if (col < f) p[static_cast<long long>(row) * f + col] = acc[x][y];
    }
  }
}

// dw[e] = part[0][e] + part[1][e] + ... + part[S - 1][e], in order
__global__ void __launch_bounds__(kGroupThreads)
dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                 long long n, int S) {
  for (long long e = grid_start(); e < n; e += grid_stride()) {
    float s = part[e];
    for (int k = 1; k < S; ++k) s += part[k * n + e];
    dw[e] = s;
  }
}

// the compaction's block sums, after the sort's scratch
inline int compact_blocks(int N) {
  return static_cast<int>((N + static_cast<long long>(kGroupThreads) - 1) /
                          kGroupThreads);
}

}  // namespace

// ints of scratch repro_spmm_plan takes for neighbors [N, M] over Nf rows
extern "C" long long repro_spmm_plan_scratch(int N, int M, int Nf) {
  const long long L = static_cast<long long>(N) * M;
  return sort_scratch(L, Nf > 0 ? Nf : 1) +
         2LL * (compact_blocks(N) > 0 ? compact_blocks(N) : 1);
}

// The plan of neighbors [N, M] int32 over Nf rows: counts [N] the valid
// lanes of each row, active [N] the active rows in order (meta's count of
// them), rank [N] each row's place among them or -1; lanes [N M] the
// valid lanes sorted by the row they read, stably, rows [N M] the
// distinct rows, starts [N M + 1] their first positions, firsts
// [ceil(N M / 8)] the row of every 8th position; meta [kMetaInts] the
// valid lanes, the distinct rows and the active rows.
extern "C" int repro_spmm_plan(const void* nbrs, void* counts, void* active,
                               void* rank, void* lanes, void* rows,
                               void* starts, void* firsts, void* meta,
                               void* scratch, int N, int M, int Nf,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long L = static_cast<long long>(N) * M;
  if (L >= (1LL << 31) || N < 0 || M < 0 || (L > 0 && Nf < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long R = Nf > 0 ? Nf : 1;   // the sort's key range
  int* m = static_cast<int*>(meta);
  cudaError_t e = cudaMemsetAsync(m, 0, sizeof(int) * kMetaInts, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  int* sc = static_cast<int*>(scratch);
  int* ln = static_cast<int*>(lanes);
  // the compacted pairs go where the sort's first pass does not write:
  // its scratch X (keys, values) or Y (keys; values in lanes)
  int* kx = sc;
  int* vx = kx + (L + 1);
  int* ky = vx + (L + 1);
  const bool to_x = pass_buffer(0, sort_passes(R)) == 1;
  int* ck = to_x ? kx : ky;
  int* cv = to_x ? vx : ln;
  const SpmmTarget tg{static_cast<const int32_t*>(nbrs), Nf};
  const int nb = compact_blocks(N);
  if (nb > 0) {
    int* bsum = sc + sort_scratch(L, R);
    compact_count<<<nb, kGroupThreads, 0, st>>>(tg, N, M,
                                                static_cast<int*>(counts),
                                                bsum, nb);
    scan_top<<<2, kGroupThreads, 0, st>>>(bsum, nb);
    compact_write<<<nb, kGroupThreads, 0, st>>>(
        tg, N, M, static_cast<const int*>(counts), bsum, nb, ck, cv,
        static_cast<int*>(active), static_cast<int*>(rank), m);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(group_sort(PairSrc{ck, cv},
                                     Count{m + kMetaValid, 0}, L, R, sc, ln,
                                     static_cast<int*>(rows),
                                     static_cast<int*>(starts),
                                     static_cast<int*>(firsts), m, st));
}

// dfeat [Nf, d] float32 from g_a [., d] float32, the projection of the
// plan's active rows, in their order: the sum over the plan's distinct
// rows, then the zeros.  mean != 0 divides each term by its row's count.
extern "C" int repro_spmm_bwd_dfeat(const void* g, const void* lanes,
                                    const void* rows, const void* starts,
                                    const void* firsts, const void* counts,
                                    const void* rank, const void* meta,
                                    void* dfeat, int N, int M, int Nf, int d,
                                    int mean, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long L = static_cast<long long>(N) * M;
  if (L >= (1LL << 31) || Nf < 0 || d < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(group_sum(
      static_cast<const float*>(g), static_cast<const int*>(lanes),
      static_cast<const int*>(rows), static_cast<const int*>(starts),
      static_cast<const int*>(firsts), static_cast<const int*>(meta), L,
      SpmmTerm{M > 0 ? M : 1, static_cast<const int*>(rank),
               static_cast<const int*>(counts)},
      mean != 0, static_cast<float*>(dfeat), Nf, d, st));
}

// dW [d, f] float32 = agg_a^T @ dout[active] over agg_a [., d] (the
// plan's active rows, in order) and dout [N, f] float32 (or, with active
// null, dout_a [., f]: those rows of dout in that order), the active rows'
// count in meta.  Scratch: part [S, d, f] float32; S splits of the rows.
extern "C" int repro_spmm_bwd_dw(const void* agg, const void* dout,
                                 const void* active, const void* meta,
                                 void* dw, void* part, int d, int f, int S,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || d < 0 || f < 0 || (d + kWT - 1) / kWT > 65535 ||
      (f + kWT - 1) / kWT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  const long long n = static_cast<long long>(d) * f;
  const dim3 grid(static_cast<unsigned>(S), (d + kWT - 1) / kWT,
                  (f + kWT - 1) / kWT);
  dw_partial_kernel<<<grid, kWThreads, 0, st>>>(
      static_cast<const float*>(agg), static_cast<const float*>(dout),
      static_cast<const int*>(active),
      Count{static_cast<const int*>(meta) + kMetaActive, 0},
      static_cast<float*>(part), d, f);
  dw_reduce_kernel<<<stride_blocks(n, kGroupThreads), kGroupThreads, 0,
                     st>>>(static_cast<const float*>(part),
                           static_cast<float*>(dw), n, S);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local (spilled) bytes a thread of body `which`, in the
// order of kernels/segment_matmul.py BWD_BODIES.
extern "C" int repro_spmm_bwd_attrs(int which, int* regs, int* local_bytes) {
  static const void* const bodies[] = {
      reinterpret_cast<const void*>(compact_count<SpmmTarget>),
      reinterpret_cast<const void*>(compact_write<SpmmTarget>),
      reinterpret_cast<const void*>(radix_totals<PairSrc>),
      reinterpret_cast<const void*>(radix_onesweep<PairSrc>),
      reinterpret_cast<const void*>(scan_top),
      reinterpret_cast<const void*>(runs_count),
      reinterpret_cast<const void*>(runs_write),
      reinterpret_cast<const void*>(group_sum_vec<8, SpmmTerm>),
      reinterpret_cast<const void*>(group_sum_vec<32, SpmmTerm>),
      reinterpret_cast<const void*>(group_sum_scalar<SpmmTerm>),
      reinterpret_cast<const void*>(zero_unread<true>),
      reinterpret_cast<const void*>(zero_unread<false>),
      reinterpret_cast<const void*>(dw_partial_kernel),
      reinterpret_cast<const void*>(dw_reduce_kernel)};
  constexpr int nb = sizeof(bodies) / sizeof(bodies[0]);
  if (which < 0 || which >= nb) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, bodies[which]);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
