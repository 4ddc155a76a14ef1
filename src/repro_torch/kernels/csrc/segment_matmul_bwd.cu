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
// float32); the wrapper refuses bf16 operands.
//
// The launches (kernels/segment_matmul.py packed_spmm_bwd):
//   * G = dout @ W^T: segment_matmul.cu's project_kernel (the 3xTF32 tile,
//     the same product shape), W^T made contiguous by the wrapper.
//   * repro_spmm_bwd_dfeat: the valid lanes grouped by the row they read
//     (lane_groups.cuh: a counting sort built here, each group in (i, m)
//     order, deterministic), then group_sum, one warp a feat row summing
//     G[i] / c_i over its group from zero.  A row no lane reads gets
//     exact zeros: at minibatch_lg 90% of rows have no child and most
//     feat rows are read by no lane.
//   * agg: segment_matmul.cu's gather_kernel over feat (the forward's
//     lane-order sum and __fdiv_rn mean).
//   * repro_spmm_bwd_dw: dw_partial_kernel, a [64, 64] tile of dW a CTA
//     over one of S splits of the rows, in row order, skipping the rows
//     with no valid lane (agg = 0: exact), FFMA; then dw_reduce_kernel
//     sums the S partials in split order.  No atomics, so a repeat is bit
//     for bit.
// Bound on the H100: dfeat reads G's rows once a lane (4 d bytes) and
// writes dfeat once (4 Nf d); dW's 2 R d f operations over the R rows
// with a child at the TF32 rate (495 TFLOP/s), which FFMA at 67 cannot
// reach; at minibatch_lg both are microseconds and the grouping's passes
// over Nf rows and the dense dfeat write set the time.
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

// cnt[i] = the valid lanes of row i
__global__ void __launch_bounds__(kGroupThreads)
row_count_kernel(const int32_t* __restrict__ nbrs, int N, int M, int Nf,
                 int* __restrict__ cnt) {
  for (long long i = grid_start(); i < N; i += grid_stride()) {
    int c = 0;
    for (int m = 0; m < M; ++m) c += nbrs[i * M + m] < Nf;
    cnt[i] = c;
  }
}

constexpr int kWT = 64;        // rows of d and columns of f a dW tile
constexpr int kWRows = 32;     // rows of agg and dout staged at once
constexpr int kWThreads = 256; // 16 x 16, a 4 x 4 block of the tile each

// part[s] [d, f] = sum over the rows i of split s with cnt[i] > 0, in
// order, of agg[i]^T dout[i], for the tile (blockIdx.y, blockIdx.z)
__global__ void __launch_bounds__(kWThreads)
dw_partial_kernel(const float* __restrict__ agg,
                  const float* __restrict__ dout,
                  const int* __restrict__ cnt, float* __restrict__ part,
                  int N, int d, int f, int rows_per_split) {
  __shared__ __align__(16) float as[kWRows][kWT];
  __shared__ __align__(16) float bs[kWRows][kWT];
  __shared__ int rows[kWThreads];
  __shared__ int warp_kept[kWThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_split;
  const long long r1 = min(static_cast<long long>(N), r0 + rows_per_split);
  const int d0 = blockIdx.y * kWT, f0 = blockIdx.z * kWT;
  float acc[4][4] = {};
  for (long long c0 = r0; c0 < r1; c0 += kWThreads) {
    // the rows of this window with a valid lane, in order
    const bool keep = c0 + tid < r1 && cnt[c0 + tid] > 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_kept[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWThreads / 32; ++w) {
      before += w < warp ? warp_kept[w] : 0;
      n += warp_kept[w];
    }
    if (keep)
      rows[before + __popc(ballot & ((1u << lane) - 1))] =
          static_cast<int>(c0 + tid);
    __syncthreads();
    for (int k0 = 0; k0 < n; k0 += kWRows) {
      for (int e = tid; e < kWRows * kWT; e += kWThreads) {
        const int rr = e / kWT, cc = e - rr * kWT;
        const bool ok = k0 + rr < n;
        const long long row = ok ? rows[k0 + rr] : 0;
        as[rr][cc] = ok && d0 + cc < d ? agg[row * d + d0 + cc] : 0.f;
        bs[rr][cc] = ok && f0 + cc < f ? dout[row * f + f0 + cc] : 0.f;
      }
      __syncthreads();
      const int nn = min(kWRows, n - k0);
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

}  // namespace

// dfeat [Nf, d] float32 from g = dout @ W^T [N, d] float32 and
// neighbors [N, M] int32: the grouping, then group_sum.  Scratch (int32):
// rowcnt [N], cnt and cursor [Nf], off [Nf + 1], bsum [scan_blocks(Nf)],
// lanes [4 N M + 1], keys [N M].  mean != 0 divides each term by its row's
// valid lanes.
extern "C" int repro_spmm_bwd_dfeat(const void* nbrs, const void* g,
                                    void* dfeat, void* rowcnt, void* cnt,
                                    void* cursor, void* off, void* bsum,
                                    void* lanes, void* keys, int N,
                                    int M, int Nf, int d, int mean,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long L = static_cast<long long>(N) * M;
  if (L >= (1LL << 31) || Nf < 0 || d < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Nf == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  const int32_t* nb = static_cast<const int32_t*>(nbrs);
  int* rc = static_cast<int*>(rowcnt);
  if (mean && N > 0)
    row_count_kernel<<<stride_blocks(N, kGroupThreads), kGroupThreads, 0,
                       st>>>(nb, N, M, Nf, rc);
  cudaError_t e = group_lanes(SpmmTarget{nb, Nf}, L, Nf,
                              static_cast<int*>(cnt),
                              static_cast<int*>(cursor),
                              static_cast<int*>(off),
                              static_cast<int*>(bsum),
                              static_cast<int*>(lanes),
                              static_cast<int*>(keys), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  group_sum<<<sum_blocks(Nf), kSumWarps * 32, 0, st>>>(
      static_cast<const float*>(g), static_cast<const int*>(keys),
      static_cast<const int*>(off), mean ? rc : nullptr,
      static_cast<float*>(dfeat), Nf, d, M, 0);
  return static_cast<int>(cudaGetLastError());
}

// dW [d, f] float32 = agg^T @ dout over agg [N, d] and dout [N, f]
// float32, the rows with no valid lane of neighbors [N, M] skipped.
// Scratch: rowcnt [N] int32, part [S, d, f] float32; S splits of the rows.
extern "C" int repro_spmm_bwd_dw(const void* nbrs, const void* agg,
                                 const void* dout, void* dw, void* rowcnt,
                                 void* part, int N, int M, int Nf, int d,
                                 int f, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || d < 0 || f < 0 || (d + kWT - 1) / kWT > 65535 ||
      (f + kWT - 1) / kWT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  const long long n = static_cast<long long>(d) * f;
  if (N == 0) {
    const cudaError_t e = cudaMemsetAsync(dw, 0, sizeof(float) * n, st);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
  int* rc = static_cast<int*>(rowcnt);
  row_count_kernel<<<stride_blocks(N, kGroupThreads), kGroupThreads, 0,
                     st>>>(static_cast<const int32_t*>(nbrs), N, M, Nf, rc);
  const int per = static_cast<int>((N + static_cast<long long>(S) - 1) / S);
  const dim3 grid(static_cast<unsigned>((N + static_cast<long long>(per) -
                                         1) / per),
                  (d + kWT - 1) / kWT, (f + kWT - 1) / kWT);
  dw_partial_kernel<<<grid, kWThreads, 0, st>>>(
      static_cast<const float*>(agg), static_cast<const float*>(dout), rc,
      static_cast<float*>(part), N, d, f, per);
  dw_reduce_kernel<<<stride_blocks(n, kGroupThreads), kGroupThreads, 0,
                     st>>>(static_cast<const float*>(part),
                           static_cast<float*>(dw), n,
                           static_cast<int>(grid.x));
  return static_cast<int>(cudaGetLastError());
}

// Registers and local (spilled) bytes a thread of body `which`, in the
// order of kernels/segment_matmul.py BWD_BODIES.
extern "C" int repro_spmm_bwd_attrs(int which, int* regs, int* local_bytes) {
  static const void* const bodies[] = {
      reinterpret_cast<const void*>(row_count_kernel),
      reinterpret_cast<const void*>(group_count<SpmmTarget>),
      reinterpret_cast<const void*>(scan_block_sums),
      reinterpret_cast<const void*>(scan_top),
      reinterpret_cast<const void*>(scan_down),
      reinterpret_cast<const void*>(group_fill<SpmmTarget>),
      reinterpret_cast<const void*>(group_order<SpmmTarget>),
      reinterpret_cast<const void*>(group_merge),
      reinterpret_cast<const void*>(group_sum),
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
