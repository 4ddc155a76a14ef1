// Causal, sliding-window, grouped-query attention for Hopper (sm_90a).
//
// Replaces the reference's TPU kernel kernels/flash_attention.py
// flash_attention_pallas (_flash_kernel): q [B, Sq, H, hd], k and v
// [B, Skv, KV, hd] with H = KV * G, all float32 or all bfloat16 ->
// out [B, Sq, H, hd] in the same type,
//
//   out[b, i, h] = sum_j p_ij v[b, j, h / G] / sum_j p_ij,
//   p_ij = exp(s_ij - max_j s_ij),  s_ij = <q[b, i, h] * hd^-0.5, k[b, j, h / G]>
//
// over the keys j with j <= q_offset + i and, for window > 0,
// j > q_offset + i - window.  As in the reference every element is widened
// to float32 first (q is scaled after widening), the scores, the online
// softmax's running (max, sum) and the accumulator are float32, and the
// output is rounded once to the input type.  The caller guarantees that
// every query row sees at least one key.
//
// Bound: at OLMo-1B's width (16 heads of 128, no GQA) a 4,096-token causal
// prefill multiplies 16 x 8.4M visible (query, key) pairs by 4 x 128
// operations: 68.7 GFLOP, 1.0 ms at 67 TFLOP/s fp32 outside the tensor
// cores, against 67 MB of q, k, v and out (0.02 ms at 3.35 TB/s).  The
// reference's arithmetic is float32, so no bf16 or TF32 tensor-core
// product stands in for it here; a decode step (Sq = 1) is bound by the
// bytes of the KV cache instead.  Design:
//   * one CTA of 256 threads per (64-query tile, q head, batch row); the
//     q tiles run from the last to the first, so the longest causal rows
//     start first;
//   * GQA is an index: head h reads KV head h / G, nothing is copied;
//   * the KV tiles a q tile can see are the loop bounds: under the causal
//     mask the loop stops at the tile of the tile's last query, under a
//     window it starts at the tile of the first query's first key, so a
//     gemma3-style 1,024-token window skips whole tiles as the reference
//     does;
//   * per KV tile of kBk keys, K is staged (widened, padded against bank
//     conflicts) and each thread computes a 4 x kBk/16 block of scores in
//     fp32 FFMA; 4 threads per query row then take the row's max, the
//     exponentials (expf) and their sum while V is staged into the
//     buffer K used; each thread then rescales and accumulates a
//     4 x HD/16 block of the output in registers;
//   * the output never leaves the registers before the final division;
//   * threads that own no live query row skip the products, so a decode
//     step (Sq = 1) multiplies in one warp of eight.
// A tensor-core (wgmma) version with split-KV decoding is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBq = 64;        // query rows per CTA
constexpr int kThreads = 256;  // 16 x 16 threads

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD>
__host__ __device__ constexpr int kv_tile() { return HD <= 128 ? 64 : 32; }

template <int HD>
constexpr size_t smem_bytes() {
  // q [kBq][HD+1], one K/V buffer [kBk][HD+1], p [kBq][kBk+1],
  // the rows' rescale factors and sums [2][kBq]
  return sizeof(float) * ((size_t)kBq * (HD + 1) +
                          (size_t)kv_tile<HD>() * (HD + 1) +
                          (size_t)kBq * (kv_tile<HD>() + 1) + 2 * kBq);
}

// HD: the head width padded up (hd <= HD; the padding is zeros).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
             int H, int KV, int hd, int window, int q_offset, float scale) {
  constexpr int kBk = kv_tile<HD>();
  constexpr int kCj = kBk / 16;   // score columns per thread
  constexpr int kDj = HD / 16;    // output columns per thread
  constexpr int kQs = HD + 1;     // row strides in shared memory
  constexpr int kPs = kBk + 1;
  extern __shared__ float smem[];
  float* qs = smem;                    // [kBq][kQs]
  float* kvs = qs + kBq * kQs;         // [kBk][kQs], K then V
  float* ps = kvs + kBk * kQs;         // [kBq][kPs]
  float* corr_s = ps + kBq * kPs;      // [kBq]
  float* l_s = corr_s + kBq;           // [kBq]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_row = (long long)H * hd;    // stride of a query row
  const long long kv_row = (long long)KV * hd;  // stride of a key row
  const T* qb = q + ((long long)b * Sq + q0) * q_row + (long long)h * hd;
  const T* kb = k + (long long)b * Skv * kv_row + (long long)kvh * hd;
  const T* vb = v + (long long)b * Skv * kv_row + (long long)kvh * hd;
  const int rows = min(kBq, Sq - q0);
  // a thread whose rows ty, ty + 16, ... are all past the last query (a
  // decode step, a ragged last tile) skips the products: at Sq = 1 only
  // the first warp multiplies
  const bool busy = ty < rows;

  for (int e = tid; e < kBq * HD; e += kThreads) {
    const int r = e / HD, c = e - r * HD;
    qs[r * kQs + c] = (r < rows && c < hd)
                          ? widen(qb[r * q_row + c]) * scale : 0.f;
  }

  // the keys this tile's rows can see: [lo, hi)
  const int first_pos = q_offset + q0, last_pos = q_offset + q0 + rows - 1;
  const int hi = min(Skv, last_pos + 1);
  const int lo = window > 0 ? max(0, first_pos - window + 1) : 0;

  // softmax threads: 4 per row, row = tid / 4, lanes part, part + 4, ...
  const int srow = tid >> 2, part = tid & 3;
  float m_run = -INFINITY, l_run = 0.f;
  float acc[4][kDj];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) acc[i][j] = 0.f;

  for (int kv0 = lo / kBk * kBk; kv0 < hi; kv0 += kBk) {
    const int keys = min(kBk, Skv - kv0);
    __syncthreads();  // the last tile's V reads are done
    for (int e = tid; e < kBk * HD; e += kThreads) {
      const int r = e / HD, c = e - r * HD;
      kvs[r * kQs + c] = (r < keys && c < hd)
                             ? widen(kb[(kv0 + r) * kv_row + c]) : 0.f;
    }
    __syncthreads();
    float s[4][kCj];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCj; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < (busy ? hd : 0); ++c) {
      float a[4], bk[kCj];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * kQs + c];
#pragma unroll
      for (int j = 0; j < kCj; ++j) bk[j] = kvs[(tx + 16 * j) * kQs + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCj; ++j) s[i][j] += a[i] * bk[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_offset + q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kCj; ++j) {
        const int kp = kv0 + tx + 16 * j;
        const bool ok = kp < kv0 + keys && kp <= qp &&
                        (window <= 0 || kp > qp - window);
        ps[(ty + 16 * i) * kPs + tx + 16 * j] = ok ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();  // scores are in ps and every K read is done
    // V into the K buffer, beside the row softmax
    for (int e = tid; e < kBk * HD; e += kThreads) {
      const int r = e / HD, c = e - r * HD;
      kvs[r * kQs + c] = (r < keys && c < hd)
                             ? widen(vb[(kv0 + r) * kv_row + c]) : 0.f;
    }
    {
      float* prow = ps + srow * kPs;
      float mx = -INFINITY;
      for (int c = part; c < kBk; c += 4) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
      for (int c = part; c < kBk; c += 4) {
        const float p = m_new == -INFINITY ? 0.f : expf(prow[c] - m_new);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = m_new == -INFINITY ? 1.f : expf(m_run - m_new);
      l_run = l_run * corr + sum;
      m_run = m_new;
      if (part == 0) corr_s[srow] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cr = corr_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kDj; ++j) acc[i][j] *= cr;
    }
#pragma unroll 4
    for (int c = 0; c < (busy ? kBk : 0); ++c) {
      float a[4], bv[kDj];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ps[(ty + 16 * i) * kPs + c];
#pragma unroll
      for (int j = 0; j < kDj; ++j) bv[j] = kvs[c * kQs + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDj; ++j) acc[i][j] += a[i] * bv[j];
    }
  }
  if (part == 0) l_s[srow] = l_run;
  __syncthreads();
  T* ob = out + ((long long)b * Sq + q0) * q_row + (long long)h * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDj; ++j) {
      const int c = tx + 16 * j;
      if (c < hd) store(ob + r * q_row + c, acc[i][j] / l);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int KV, int hd, int window, int q_offset,
           float scale, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBq - 1) / kBq, H, B);
  flash_kernel<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, KV, hd,
      window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Skv, int H, int KV, int hd, int window,
             int q_offset, float scale, cudaStream_t st) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, out, B, Sq, Skv, H, KV, hd, window,
                         q_offset, scale, st);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, KV, hd, window,
                         q_offset, scale, st);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, KV, hd, window,
                          q_offset, scale, st);
  return launch<T, 256>(q, k, v, out, B, Sq, Skv, H, KV, hd, window,
                        q_offset, scale, st);
}

}  // namespace

// q [B, Sq, H, hd], k and v [B, Skv, KV, hd] -> out [B, Sq, H, hd], all
// float32 (bf16 == 0) or all bfloat16 (bf16 == 1), contiguous; hd <= 256,
// H a multiple of KV, B and H at most 65,535.  window <= 0 is causal only.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Skv, int H, int KV, int hd,
                                     int window, int q_offset, float scale,
                                     int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || H == 0 || hd == 0)
    return static_cast<int>(cudaGetLastError());
  if (hd > 256 || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KV, hd,
                                   window, q_offset, scale, st);
  return dispatch<float>(q, k, v, out, B, Sq, Skv, H, KV, hd, window,
                         q_offset, scale, st);
}
