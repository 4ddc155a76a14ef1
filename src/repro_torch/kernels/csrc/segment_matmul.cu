// Packed SpMM for Hopper (sm_90a): a fixed-degree neighbour gather, its
// sum or mean, and the product with W, in one kernel.
//
// Replaces the reference's TPU kernel kernels/segment_matmul.py
// packed_spmm_pallas (_spmm_kernel):
//   agg[i] = sum over t < M with nbrs[i, t] < Nf of feat[max(nbrs[i, t], 0)]
//   agg[i] = agg[i] / max(cnt_i, 1)                            (mean)
//   out[i] = agg[i] @ W
// neighbors [N, M] int32, feat [Nf, d] float32, W [d, f] float32 ->
// out [N, f] float32.  Ids >= Nf are sentinels and skipped; a negative id
// reads row 0 and counts, as the reference's plain path clips it.  The sum
// runs in fp32 in the order t = 0 .. M-1 from zero, a skipped lane adding
// 0.0, as the reference's body does.  The product with W is this kernel's
// own work, as the TPU kernel contracts on its MXU in the same body: the
// [N, d] aggregate never reaches device memory.
//
// Bound: at GraphSAGE's first layer on Reddit (N = Nf = 232,965, M = 15,
// d = 602, f = 128, mean) the product is 35.9 GFLOP, 0.54 ms at 67 TFLOP/s
// fp32 outside the tensor cores, while the inputs read once and the output
// are 0.7 GB, 0.21 ms at 3.35 TB/s: operations.  But the gather reads
// N * M rows of d floats, 8.4 GB before the sentinels are taken out
// (2.5 ms), at random, so the row reads set the pace.  Design, in
// block.cu's idiom:
//   * one CTA of 256 threads per 64 output rows x 128 output columns; it
//     stages its rows' neighbour ids (clipped, -1 for a sentinel) and the
//     mean's divisors in shared memory once;
//   * per d-chunk of 32, each warp gathers 8 of the 64 rows: lane k reads
//     element d0 + k of every neighbour row (one 128-byte read per row),
//     with up to kBatch row reads in flight before the adds; the mean
//     divides element by element (__fdiv_rn), the same arithmetic as
//     dividing the whole row; the [64, 32] aggregate is staged k-major in
//     shared memory beside W[d0 : d0 + 32, f-tile];
//   * each thread accumulates a 4 x 8 micro-tile of the output in fp32
//     FFMA; no TF32.
// A row is gathered once per 128-column tile of the output: once for
// f <= 128.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // output rows per CTA
constexpr int kCols = 128;     // output columns per CTA
constexpr int kDc = 32;        // d chunk per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 8 outputs each
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 16;     // neighbour rows read before the adds

__global__ void __launch_bounds__(kThreads)
spmm_kernel(const int32_t* __restrict__ nbrs, const float* __restrict__ feat,
            const float* __restrict__ w, float* __restrict__ out, int N,
            int M, int Nf, int d, int f, int mean) {
  extern __shared__ int32_t sid[];         // [kRows][M]: row, or -1
  __shared__ float as[kDc][kRows + 1];     // aggregate chunk, [k][row]
  __shared__ float ws[kDc][kCols];         // W chunk, [k][col]
  __shared__ float sdiv[kRows];            // max(cnt, 1)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const long long r0 = (long long)blockIdx.x * kRows;
  const int f0 = blockIdx.y * kCols;
  for (int e = tid; e < kRows * M; e += kThreads) {
    int32_t id = -1;
    if (r0 + e / M < N) {
      id = __ldg(nbrs + r0 * M + e);
      id = id >= Nf ? -1 : (id < 0 ? 0 : id);
    }
    sid[e] = id;
  }
  __syncthreads();
  if (tid < kRows) {
    int cnt = 0;
    for (int t = 0; t < M; ++t) cnt += sid[tid * M + t] >= 0;
    sdiv[tid] = static_cast<float>(cnt > 1 ? cnt : 1);
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < d; d0 += kDc) {
    __syncthreads();
    const int k = d0 + lane;
    for (int r = warp; r < kRows; r += kWarps) {
      const int32_t* rid = sid + r * M;
      float sum = 0.f;
      for (int t0 = 0; t0 < M; t0 += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          v[u] = 0.f;
          if (t0 + u < M && k < d) {
            const int32_t id = rid[t0 + u];
            if (id >= 0) v[u] = __ldg(feat + (long long)id * d + k);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (t0 + u < M) sum += v[u];
        }
      }
      as[lane][r] = mean ? __fdiv_rn(sum, sdiv[r]) : sum;
    }
    for (int e = tid; e < kDc * kCols; e += kThreads) {
      const int kk = e / kCols, c = e - kk * kCols;
      ws[kk][c] = (d0 + kk < d && f0 + c < f)
                      ? __ldg(w + (long long)(d0 + kk) * f + f0 + c) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDc; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = r0 + ty + 16 * i;
    if (r >= N) continue;
    float* orow = out + r * f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = f0 + tx + 16 * j;
      if (c < f) orow[c] = acc[i][j];
    }
  }
}

}  // namespace

// neighbors [N, M] int32, feat [Nf, d] float32, w [d, f] float32 ->
// out [N, f] float32; mean != 0 divides each aggregate by its valid count.
extern "C" int repro_packed_spmm(const void* nbrs, const void* feat,
                                 const void* w, void* out, int N, int M,
                                 int Nf, int d, int f, int mean,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  const int f_tiles = (f + kCols - 1) / kCols;
  if (f_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)kRows * M * sizeof(int32_t);
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        spmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((N + (long long)kRows - 1) / kRows),
                  f_tiles);
  spmm_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const int32_t*>(nbrs), static_cast<const float*>(feat),
      static_cast<const float*>(w), static_cast<float*>(out), N, M, Nf, d, f,
      mean);
  return static_cast<int>(cudaGetLastError());
}
