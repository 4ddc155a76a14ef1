// Gather-fused distance block for Hopper (sm_90a).
//
// Replaces the reference's TPU kernel kernels/l2dist.py
// gather_block_distances_pallas (fp32 body _gather_block_kernel and the
// self-query body _self_q_gather_kernel):
//
//   out[s, q, c] = qn + vn - 2 * <Q[s, q], X[idx[s, c]]>   (l2)
//   out[s, q, c] = -<Q[s, q], X[idx[s, c]]>                (ip / cos)
//
// with 3.4e38 for lanes whose mask is 0 or whose id lies outside [0, N);
// ids are clipped into [0, N) before the gather.  Self-query mode scores
// the gathered rows against themselves: out [S, C, C], the mask applied to
// the column (candidate) axis only, as in the reference.
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

template <bool VEC>
__global__ void __launch_bounds__(kRowThreads)
gather_rowq_kernel(const float* __restrict__ Q, const float* __restrict__ X,
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
    const float* v = X + (long long)id * d;
    float vn = 0.f;
    for (int q = 0; q < Kq; ++q) {
      const float* qq = qrow + (long long)q * d;
      float dot = 0.f, qn = 0.f, vv = 0.f;
      if (VEC) {
        for (int j = lane * 4; j < d; j += 128) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(v + j));
          const float4 b = __ldg(reinterpret_cast<const float4*>(qq + j));
          dot += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
          qn += b.x * b.x + b.y * b.y + b.z * b.z + b.w * b.w;
          vv += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
        }
      } else {
        for (int j = lane; j < d; j += 32) {
          const float a = __ldg(v + j), b = __ldg(qq + j);
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

}  // namespace

extern "C" int repro_gather_distances(const void* Q, const void* X,
                                      const void* idx, const void* mask,
                                      void* out, int S, int Kq, int C, int d,
                                      long long N, int ip, int self_q,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 0 || C == 0) return static_cast<int>(cudaGetLastError());
  const float* x = static_cast<const float*>(X);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  if (self_q) {
    const size_t smem = sizeof(float) * ((size_t)C * (kSqDc + 1) + C)
                        + sizeof(int) * 2 * (size_t)C;
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(gather_selfq_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    gather_selfq_kernel<<<S, kSqThreads, smem, st>>>(x, ix, m, o, C, d, N,
                                                     ip);
  } else {
    const float* q = static_cast<const float*>(Q);
    const bool vec = (d % 4 == 0)
        && (reinterpret_cast<uintptr_t>(x) % 16 == 0)
        && (reinterpret_cast<uintptr_t>(q) % 16 == 0);
    if (vec) {
      gather_rowq_kernel<true><<<S, kRowThreads, 0, st>>>(q, x, ix, m, o, Kq,
                                                          C, d, N, ip);
    } else {
      gather_rowq_kernel<false><<<S, kRowThreads, 0, st>>>(q, x, ix, m, o,
                                                           Kq, C, d, N, ip);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
