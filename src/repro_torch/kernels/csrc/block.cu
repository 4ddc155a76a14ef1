// Distance block over pre-gathered rows for Hopper (sm_90a).
//
// Replaces the reference's TPU kernel kernels/l2dist.py
// block_distances_pallas (fp32 body _block_kernel and int8 body
// _block_kernel_quant):
//
//   out[s, q, c] = qn + vn - 2 * <Q[s, q], V[s, c]>   (l2)
//   out[s, q, c] = -<Q[s, q], V[s, c]>                (ip / cos)
//
// Q [S, Kq, d] float32, V [S, C, d] float32 or int8 codes with
// v_scales [S, C] float32, mask [S, C] (0 -> 3.4e38) -> out [S, Kq, C].
// The int8 body dequantizes while it stages, v = float(code) * scale
// (rounded once, as the reference's widen-then-scale), and vn is taken over
// the dequantized values.  Its main caller is scan_distances, the
// brute-force scan of the streaming delta shard: S = 1, Kq = the query
// batch (up to 10240), C = the delta capacity.
//
// Bound: that scan is a GEMM.  At B = 10240 x cap = 16384 x d = 128 it is
// 42.9 GFLOP (0.64 ms at 67 TFLOP/s fp32 outside the tensor cores) and
// writes a 671 MB output (0.20 ms at 3.35 TB/s), so the operations bound
// it; no TF32 anywhere, the reference's distances are full fp32.  Design:
//   * one CTA per 64 x 64 output tile over a grid (C tiles, Kq tiles, S),
//     so the scan's single row s spreads over every SM;
//   * per d-chunk of 32, the CTA stages a 64 x 32 slice of Q and of V in
//     shared memory (k-major, padded against bank conflicts) and each of
//     its 256 threads accumulates a 4 x 4 micro-tile in fp32 FFMA;
//   * the row norms are summed from the same staged slices, and the
//     epilogue applies the norm formula and the mask as it stores.
// A wgmma / TMA pipeline is later work.
//
// The same tile also serves the reference's dense kernel
// kernels/l2dist.py distance_matrix_pallas (_dist_kernel): Q [B, d] x
// X [N, d] -> out [B, N] float32, the same formula with S = 1 and no mask
// (repro_distance_matrix below).  Q and X are float32 or bfloat16; a
// bfloat16 element is widened with __bfloat162float while it is staged,
// the reference's .astype(float32), so the products and sums stay fp32.
// Its full-size caller is the exact k-NN of 1,024 queries against a
// 2^20 x 128 corpus: 275 GFLOP (4.1 ms at 67 TFLOP/s) against 4.3 GB of
// output (1.3 ms at 3.35 TB/s), so the operations bound it as well.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kTile = 64;     // output rows (Kq) and columns (C) per CTA
constexpr int kDc = 32;       // d chunk staged per step
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = kTile + 1;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// T: the element type of Q and (unless QUANT) of V, widened to float as
// it is staged.
template <typename T, bool QUANT>
__global__ void __launch_bounds__(kThreads)
block_kernel(const T* __restrict__ Q, const void* __restrict__ V,
             const float* __restrict__ v_scales,
             const uint8_t* __restrict__ mask, float* __restrict__ out,
             int S, int Kq, int C, int d, int ip) {
  __shared__ float qs[kDc][kPad];   // [k][row]
  __shared__ float vs[kDc][kPad];   // [k][col]
  __shared__ float qn_s[kTile], vn_s[kTile];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c0 = blockIdx.x * kTile, q0 = blockIdx.y * kTile;
  for (long long s = blockIdx.z; s < S; s += gridDim.z) {
    const T* qb = Q + s * Kq * d;
    const long long vb = s * C * d;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float nacc = 0.f;  // threads 0-63: qn of row tid; 64-127: vn of col
    for (int d0 = 0; d0 < d; d0 += kDc) {
      __syncthreads();
      // stage: a warp reads 32 consecutive elements of one row
      for (int e = tid; e < kTile * kDc; e += kThreads) {
        const int r = e / kDc, k = e - r * kDc;
        const bool in_d = d0 + k < d;
        const int q = q0 + r, c = c0 + r;
        qs[k][r] = (in_d && q < Kq)
                       ? load_f(qb + (long long)q * d + d0 + k) : 0.f;
        float v = 0.f;
        if (in_d && c < C) {
          const long long off = vb + (long long)c * d + d0 + k;
          if constexpr (QUANT) {
            v = __fmul_rn(
                static_cast<float>(static_cast<const int8_t*>(V)[off]),
                __ldg(v_scales + s * C + c));
          } else {
            v = load_f(static_cast<const T*>(V) + off);
          }
        }
        vs[k][r] = v;
      }
      __syncthreads();
      if (tid < kTile) {
#pragma unroll 8
        for (int k = 0; k < kDc; ++k) nacc += qs[k][tid] * qs[k][tid];
      } else if (tid < 2 * kTile) {
#pragma unroll 8
        for (int k = 0; k < kDc; ++k) {
          nacc += vs[k][tid - kTile] * vs[k][tid - kTile];
        }
      }
#pragma unroll 8
      for (int k = 0; k < kDc; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = vs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
      }
    }
    if (tid < kTile) qn_s[tid] = nacc;
    else if (tid < 2 * kTile) vn_s[tid - kTile] = nacc;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + ty + 16 * i;
      if (q >= Kq) continue;
      float* orow = out + (s * Kq + q) * (long long)C;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c >= C) continue;
        float r = ip ? -acc[i][j]
                     : (qn_s[ty + 16 * i] + vn_s[tx + 16 * j])
                           - 2.f * acc[i][j];
        if (mask != nullptr && mask[s * C + c] == 0) r = kInf;
        orow[c] = r;
      }
    }
  }
}

}  // namespace

// V is float32 [S, C, d], or int8 codes [S, C, d] when v_scales
// ([S, C] float32) is not null.  mask [S, C] may be null (all valid).
extern "C" int repro_block_distances(const void* Q, const void* V,
                                     const void* v_scales, const void* mask,
                                     void* out, int S, int Kq, int C, int d,
                                     int ip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 0 || Kq == 0 || C == 0) return static_cast<int>(cudaGetLastError());
  const int q_tiles = (Kq + kTile - 1) / kTile;
  if (q_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + kTile - 1) / kTile, q_tiles, S < 65535 ? S : 65535);
  const float* q = static_cast<const float*>(Q);
  const float* sc = static_cast<const float*>(v_scales);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  if (sc != nullptr) {
    block_kernel<float, true><<<grid, kThreads, 0, st>>>(q, V, sc, m, o, S,
                                                         Kq, C, d, ip);
  } else {
    block_kernel<float, false><<<grid, kThreads, 0, st>>>(q, V, sc, m, o, S,
                                                          Kq, C, d, ip);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dense distance matrix: Q [B, d] x X [N, d] -> out [B, N] float32, both
// inputs float32 (bf16 == 0) or bfloat16 (bf16 == 1).
extern "C" int repro_distance_matrix(const void* Q, const void* X, void* out,
                                     int B, int N, int d, int ip, int bf16,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const int q_tiles = (B + kTile - 1) / kTile;
  if (q_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kTile - 1) / kTile, q_tiles, 1);
  float* o = static_cast<float*>(out);
  if (bf16) {
    block_kernel<__nv_bfloat16, false><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(Q), X, nullptr, nullptr, o, 1, B,
        N, d, ip);
  } else {
    block_kernel<float, false><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(Q), X, nullptr, nullptr, o, 1, B, N, d,
        ip);
  }
  return static_cast<int>(cudaGetLastError());
}
