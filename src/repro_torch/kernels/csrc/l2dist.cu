// Gather-fused distance block for Hopper (sm_90a).
//
// Replaces the reference's TPU kernel kernels/l2dist.py
// gather_block_distances_pallas (fp32 body _gather_block_kernel, int8 body
// _gather_block_kernel_quant and the self-query body _self_q_gather_kernel):
//
//   out[s, q, c] = qn + vn - 2 * <Q[s, q], X[idx[s, c]]>   (l2)
//   out[s, q, c] = -<Q[s, q], X[idx[s, c]]>                (ip / cos)
//
// with 3.4e38 for lanes whose mask is 0 or whose id lies outside [0, N);
// ids are clipped into [0, N) before the gather.  Self-query mode scores
// the gathered rows against themselves: out [S, C, C], the mask applied to
// the column (candidate) axis only, as in the reference.  The int8 body
// reads X as per-row codes [N, d] int8 with scales [N] float32 and
// dequantizes in registers, v = float(code) * scale[id] (rounded once, as
// the reference's widen-then-scale), before the same formula; vn is taken
// over the dequantized values, not as scale^2 * sum(code^2).
//
// Bound: memory.  Per call it must move every gathered row once
// (S * C * d * 4 bytes for the valid lanes) and write S * Kq * C floats;
// the arithmetic is 2 flops per byte gathered, far under the card's
// ridge.  Design against that bound:
//   * the row kernel gives one CTA to one row s and one warp to one
//     candidate: a warp reads a whole 512-byte row (d = 128) with one
//     16-byte load per lane, coalesced, and reduces with shuffles, so
//     no row is staged in shared memory and nothing is read twice;
//   * masked / out-of-range lanes skip their gather altogether;
//   * the int8 body moves a quarter of the bytes: a 128-byte row
//     (d = 128) is one char4 load per lane, plus one scale per candidate;
//   * the self-query kernel stages the C rows of one tile in shared memory
//     a d-chunk at a time (C x 32 floats), so every row is read from
//     device memory once per tile and reused by all C^2 pair products,
//     and any d (GIST's 960 included) fits without refusing a shape.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kRowThreads = 256;
constexpr int kSqThreads = 256;
constexpr int kSqEpt = 16;   // pair entries per thread per pass
constexpr int kSqDc = 32;    // d chunk staged in shared memory

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One row element group: 4 fp32 values, or 4 int8 codes dequantized.
template <bool QUANT>
__device__ __forceinline__ float4 load4(const void* X, long long off,
                                        float sc) {
  if constexpr (QUANT) {
    const char4 c = __ldg(reinterpret_cast<const char4*>(
        static_cast<const int8_t*>(X) + off));
    return make_float4(__fmul_rn(static_cast<float>(c.x), sc),
                       __fmul_rn(static_cast<float>(c.y), sc),
                       __fmul_rn(static_cast<float>(c.z), sc),
                       __fmul_rn(static_cast<float>(c.w), sc));
  } else {
    return __ldg(reinterpret_cast<const float4*>(
        static_cast<const float*>(X) + off));
  }
}

template <bool QUANT>
__device__ __forceinline__ float load1(const void* X, long long off,
                                       float sc) {
  if constexpr (QUANT) {
    return __fmul_rn(
        static_cast<float>(static_cast<const int8_t*>(X)[off]), sc);
  } else {
    return __ldg(static_cast<const float*>(X) + off);
  }
}

template <bool VEC, bool QUANT>
__global__ void __launch_bounds__(kRowThreads)
gather_rowq_kernel(const float* __restrict__ Q, const void* __restrict__ X,
                   const float* __restrict__ scales,
                   const int32_t* __restrict__ idx,
                   const uint8_t* __restrict__ mask, float* __restrict__ out,
                   int Kq, int C, int d, long long N, int ip) {
  const long long s = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const float* qrow = Q + s * Kq * d;
  for (int c = warp; c < C; c += nwarps) {
    const long long lc = s * C + c;
    const int32_t id = idx[lc];
    const bool valid = (mask == nullptr || mask[lc] != 0) && id >= 0 && id < N;
    float* o = out + s * Kq * C + c;
    if (!valid) {  // warp-uniform: the whole warp skips the gather
      for (int q = lane; q < Kq; q += 32) o[(long long)q * C] = kInf;
      continue;
    }
    const long long v = (long long)id * d;
    const float sc = QUANT ? __ldg(scales + id) : 1.f;
    float vn = 0.f;
    for (int q = 0; q < Kq; ++q) {
      const float* qq = qrow + (long long)q * d;
      float dot = 0.f, qn = 0.f, vv = 0.f;
      if (VEC) {
        for (int j = lane * 4; j < d; j += 128) {
          const float4 a = load4<QUANT>(X, v + j, sc);
          const float4 b = __ldg(reinterpret_cast<const float4*>(qq + j));
          dot += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
          qn += b.x * b.x + b.y * b.y + b.z * b.z + b.w * b.w;
          vv += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
        }
      } else {
        for (int j = lane; j < d; j += 32) {
          const float a = load1<QUANT>(X, v + j, sc), b = __ldg(qq + j);
          dot += a * b;
          qn += b * b;
          vv += a * a;
        }
      }
      dot = warp_sum(dot);
      if (!ip) {
        qn = warp_sum(qn);
        if (q == 0) vn = warp_sum(vv);
      }
      if (lane == 0) o[(long long)q * C] = ip ? -dot : (qn + vn) - 2.f * dot;
    }
  }
}

__global__ void __launch_bounds__(kSqThreads)
gather_selfq_kernel(const float* __restrict__ X,
                    const int32_t* __restrict__ idx,
                    const uint8_t* __restrict__ mask, float* __restrict__ out,
                    int K, int d, long long N, int ip) {
  extern __shared__ float smem[];
  float* rows = smem;                        // [K][kSqDc + 1]
  float* norms = rows + K * (kSqDc + 1);     // [K]
  int* rid = reinterpret_cast<int*>(norms + K);   // [K] clipped ids
  int* rval = rid + K;                       // [K] column validity
  const long long s = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  for (int i = tid; i < K; i += blockDim.x) {
    const long long li = s * K + i;
    const int32_t id = idx[li];
    rval[i] = (mask == nullptr || mask[li] != 0) && id >= 0 && id < N;
    rid[i] = id < 0 ? 0 : (id >= N ? (int)(N - 1) : id);
  }
  __syncthreads();
  for (int i = warp; i < K; i += nwarps) {
    const float* v = X + (long long)rid[i] * d;
    float acc = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float a = __ldg(v + j);
      acc += a * a;
    }
    acc = warp_sum(acc);
    if (lane == 0) norms[i] = acc;
  }
  const int KK = K * K;
  for (int base = 0; base < KK; base += kSqThreads * kSqEpt) {
    float acc[kSqEpt];
#pragma unroll
    for (int t = 0; t < kSqEpt; ++t) acc[t] = 0.f;
    for (int d0 = 0; d0 < d; d0 += kSqDc) {
      const int dc = min(kSqDc, d - d0);
      __syncthreads();
      for (int e = tid; e < K * kSqDc; e += blockDim.x) {
        const int r = e / kSqDc, col = e - r * kSqDc;
        rows[r * (kSqDc + 1) + col] =
            col < dc ? __ldg(X + (long long)rid[r] * d + d0 + col) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kSqEpt; ++t) {
        const int e = base + t * kSqThreads + tid;
        if (e < KK) {
          const int i = e / K, j = e - (e / K) * K;
          const float* a = rows + i * (kSqDc + 1);
          const float* b = rows + j * (kSqDc + 1);
          float part = 0.f;
          for (int c = 0; c < dc; ++c) part += a[c] * b[c];
          acc[t] += part;
        }
      }
    }
    __syncthreads();  // norms written before the first pass are visible
#pragma unroll
    for (int t = 0; t < kSqEpt; ++t) {
      const int e = base + t * kSqThreads + tid;
      if (e < KK) {
        const int i = e / K, j = e - (e / K) * K;
        const float r = ip ? -acc[t] : (norms[i] + norms[j]) - 2.f * acc[t];
        out[s * KK + e] = rval[j] ? r : kInf;
      }
    }
  }
}

template <bool VEC, bool QUANT>
void launch_rowq(const float* q, const void* x, const float* sc,
                 const int32_t* ix, const uint8_t* m, float* o, int S,
                 int Kq, int C, int d, long long N, int ip,
                 cudaStream_t st) {
  gather_rowq_kernel<VEC, QUANT><<<S, kRowThreads, 0, st>>>(
      q, x, sc, ix, m, o, Kq, C, d, N, ip);
}

}  // namespace

// X is float32 [N, d], or int8 codes [N, d] when scales ([N] float32) is
// not null.  Self-query tiles take float32 rows only.
extern "C" int repro_gather_distances(const void* Q, const void* X,
                                      const void* scales, const void* idx,
                                      const void* mask, void* out, int S,
                                      int Kq, int C, int d, long long N,
                                      int ip, int self_q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 0 || C == 0) return static_cast<int>(cudaGetLastError());
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  if (self_q) {
    if (sc != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) * ((size_t)C * (kSqDc + 1) + C)
                        + sizeof(int) * 2 * (size_t)C;
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(gather_selfq_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    gather_selfq_kernel<<<S, kSqThreads, smem, st>>>(
        static_cast<const float*>(X), ix, m, o, C, d, N, ip);
    return static_cast<int>(cudaGetLastError());
  }
  const float* q = static_cast<const float*>(Q);
  const size_t align = sc != nullptr ? 4 : 16;  // char4 vs float4 rows
  const bool vec = (d % 4 == 0)
      && (reinterpret_cast<uintptr_t>(X) % align == 0)
      && (reinterpret_cast<uintptr_t>(q) % 16 == 0);
  if (sc != nullptr) {
    if (vec) launch_rowq<true, true>(q, X, sc, ix, m, o, S, Kq, C, d, N, ip, st);
    else launch_rowq<false, true>(q, X, sc, ix, m, o, S, Kq, C, d, N, ip, st);
  } else {
    if (vec) launch_rowq<true, false>(q, X, sc, ix, m, o, S, Kq, C, d, N, ip, st);
    else launch_rowq<false, false>(q, X, sc, ix, m, o, S, Kq, C, d, N, ip, st);
  }
  return static_cast<int>(cudaGetLastError());
}
