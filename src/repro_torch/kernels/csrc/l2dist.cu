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
//   * the fp32 row kernel gives one CTA to one row s and one warp to one
//     candidate: a warp reads a whole 512-byte row (d = 128) with one
//     16-byte load per lane, coalesced, and reduces with shuffles, so
//     no row is staged in shared memory and nothing is read twice;
//   * masked / out-of-range lanes skip their gather altogether;
//   * the int8 body moves a quarter of the bytes (a 128-byte row at
//     d = 128, plus one scale a candidate), so it is bound by latency,
//     not bandwidth: a warp that walks its candidates one by one waits
//     on idx, mask, scale and row in turn for each.  So one warp owns a
//     row s and all of its loads are in flight together: lane c loads
//     idx, mask and scale of candidate c (one coalesced load each, 32
//     candidates a block), then each group of 8 lanes takes one candidate
//     row in 16-byte pieces, 4 candidates a warp instruction, and every
//     lane issues its 8 pieces of the block's candidates before it uses
//     any.  A warp's critical path is two dependent round trips (idx,
//     then codes and scales).  Each lane keeps its 16 floats of the
//     query in registers, qn is summed once a query, the 8 candidates'
//     sums leave the 8-lane group by a 7-shuffle reduce-scatter (lane j
//     of a group ends with candidate j's sum), and the block's results go
//     out as one coalesced store.  Codes become exact floats by a byte
//     permute into 2^23's mantissa and one subtraction, cheaper than the
//     int-to-float conversion;
//   * the bf16 body (a mesh plane's db_bf16 database: the reference's
//     gather body takes X at any float dtype and upcasts each row in
//     VMEM) moves half the fp32 row's bytes, 256 at d = 128, so like the
//     int8 body it is bound by latency more than by bandwidth, and it has
//     the int8 body's shape: one warp owns a row s, lane c loads idx and
//     mask of candidate c, each group of 8 lanes takes one candidate row
//     in 16-byte pieces of 8 bf16 elements (64 elements a pass), and all 8
//     pieces of a lane are issued before any is used.  A bf16 element
//     becomes its exact fp32 value by a 16-bit shift (no conversion
//     instruction), and sums run in fp32 in the fp32 formula.  Pointers
//     that are not 16-byte aligned, or d % 8 != 0, take an element-wise
//     body with the same lanes and sums;
//   * the self-query kernel (the diversify tiles, [T, K, K] with K = 32
//     and 64) does K^2 d products on K d floats in and K^2 out: 21 flops
//     a byte at K = 64, the fp32 FFMA ridge (20) and far under the TF32
//     tensor cores' (148).  So it runs the products on tensor cores in
//     3xTF32 (mma_tf32.cuh): the reference's distances are fp32, and one
//     TF32 rounding of the operands misses 1e-5 * (qn + vn) many times
//     over, while the split holds it.  Persistent CTAs of 4 warps each
//     stage 64 rows at a time (one K = 64 tile, two of K = 32, four of
//     K <= 16) with 16-byte cp.async into rows padded to 8 mod 32 words
//     against bank conflicts and zero-filled past d and K, so d and K
//     need not be multiples of 8 or 16.  With d <= 128 the next group's
//     rows load into a second buffer while this one multiplies; a larger
//     d (GIST's 960) streams through the two buffers in 128-column chunks.
//     Each warp owns a 16-row strip of a tile's K x K block (up to 64
//     columns) and splits the operands into hi + lo as it loads them; the
//     norms are fp32 FFMA sums of the staged rows, and the epilogue writes
//     the formula and the column mask from the accumulator fragments
//     (8-byte stores).  Each row is read from device memory once per
//     tile, and K may reach 1,024 (two buffers of 1,024 rows of 16
//     columns fill a CTA's shared memory).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma_tf32.cuh"

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kRowThreads = 256;
constexpr int kSqWarps = 4;
constexpr int kSqThreads = 32 * kSqWarps;
constexpr int kSqRows = 64;      // rows a self-query CTA stages (K <= 64)
constexpr int kSqMaxDc = 128;    // d columns a staged chunk
constexpr int kSqMinDc = 16;
constexpr size_t kMaxSmem = 232448;   // a CTA's shared memory on sm_90

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
    const long long v = (long long)id * d;
    float vn = 0.f;
    for (int q = 0; q < Kq; ++q) {
      const float* qq = qrow + (long long)q * d;
      float dot = 0.f, qn = 0.f, vv = 0.f;
      if (VEC) {
        for (int j = lane * 4; j < d; j += 128) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(X + v + j));
          const float4 b = __ldg(reinterpret_cast<const float4*>(qq + j));
          dot += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
          qn += b.x * b.x + b.y * b.y + b.z * b.z + b.w * b.w;
          vv += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
        }
      } else {
        for (int j = lane; j < d; j += 32) {
          const float a = __ldg(X + v + j), b = __ldg(qq + j);
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

// --------------------------------------------------------------------------
// the int8 row body: one warp a row s
// --------------------------------------------------------------------------

constexpr int kRow8Slots = 8;   // candidates a lane sums (32 / 4 groups)

// 16 codes of a candidate row from byte `off` on, as 4 words: one 16-byte
// load where rows are 16-byte aligned (VEC: d % 16 == 0), else byte by
// byte; zeros past d and for a lane without a row (id < 0).
template <bool VEC>
__device__ __forceinline__ uint4 load_codes(const int8_t* X, int id, int off,
                                            int d) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (id < 0 || off >= d) return r;
  const int8_t* p = X + static_cast<long long>(id) * d + off;
  if constexpr (VEC) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (off + e < d)
        w[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + e)))
                     << (8 * (e & 3));
    r = make_uint4(w[0], w[1], w[2], w[3]);
  }
  return r;
}

// 16 query floats from `off` on (zeros past d): four 16-byte loads (VEC)
// or one at a time.
template <bool VEC>
__device__ __forceinline__ void load_query(const float* q, int off, int d,
                                           float (&v)[16]) {
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 a = off < d
          ? __ldg(reinterpret_cast<const float4*>(q + off) + j)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * j] = a.x;
      v[4 * j + 1] = a.y;
      v[4 * j + 2] = a.z;
      v[4 * j + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = off + e < d ? __ldg(q + off + e) : 0.f;
  }
}

// Signed byte k of w as an exact float: the byte, biased by 128, becomes
// the low mantissa bits of 2^23, and one subtraction removes 2^23 + 128.
template <int K>
__device__ __forceinline__ float code_at(uint32_t w) {
  const uint32_t f = __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 | K);
  return __fsub_rn(__uint_as_float(f), 8388736.f);
}

// The 8-lane group's sums of v[0..7], scattered: lane j of the group ends
// with the sum of v[j] over the group (3 halving steps, 4 + 2 + 1
// shuffles).
__device__ __forceinline__ float sum8_scatter(float (&v)[kRow8Slots],
                                              int sub) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) {
    const bool hi = (sub & o) != 0;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = hi ? v[i] : v[i + o];
      const float keep = hi ? v[i + o] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  return v[0];
}

// Warp w of a CTA owns row s = 8 * blockIdx.x + w.  Candidates go in
// blocks of 32: lane c holds candidate cb + c's clipped id (-1: masked or
// out of range) and scale; lane g * 8 + j sums slots t = 0..7, candidate
// cb + 4t + g, over bytes [16 j, 16 j + 16) of each 128-byte pass of d,
// and ends with candidate cb + 4j + g's sums.  With d <= 128 (one pass)
// the codes stay in registers across the Kq queries.
template <bool VEC>
__global__ void __launch_bounds__(kRowThreads)
gather_row8_kernel(const float* __restrict__ Q, const int8_t* __restrict__ X,
                   const float* __restrict__ scales,
                   const int32_t* __restrict__ idx,
                   const uint8_t* __restrict__ mask, float* __restrict__ out,
                   int S, int Kq, int C, int d, long long N, int ip) {
  constexpr unsigned kFull = 0xffffffffu;
  const long long s = static_cast<long long>(blockIdx.x) * (kRowThreads / 32)
                      + (threadIdx.x >> 5);
  if (s >= S) return;   // warp-uniform
  const int lane = threadIdx.x & 31, g = lane >> 3, sub = lane & 7;
  const int passes = (d + 127) >> 7;
  for (int cb = 0; cb < C; cb += 32) {
    int id = -1;
    float sc = 0.f;
    if (cb + lane < C) {
      const long long lc = s * C + cb + lane;
      const int32_t raw = __ldg(idx + lc);
      if ((mask == nullptr || __ldg(mask + lc) != 0) && raw >= 0 && raw < N) {
        id = raw;
        sc = __ldg(scales + raw);
      }
    }
    int sid[kRow8Slots];
#pragma unroll
    for (int t = 0; t < kRow8Slots; ++t)
      sid[t] = __shfl_sync(kFull, id, 4 * t + g);
    const int mine = __shfl_sync(kFull, id, 4 * sub + g);
    uint4 code[kRow8Slots];
    for (int q = 0; q < Kq; ++q) {
      const float* qrow = Q + (s * Kq + q) * d;
      float dot[kRow8Slots] = {}, vv[kRow8Slots] = {}, qn = 0.f;
      for (int p = 0; p < passes; ++p) {
        const int off = p * 128 + sub * 16;
        if (q == 0 || passes > 1) {
#pragma unroll
          for (int t = 0; t < kRow8Slots; ++t)
            code[t] = load_codes<VEC>(X, sid[t], off, d);
        }
        float qv[16];
        load_query<VEC>(qrow, off, d, qv);
#pragma unroll
        for (int e = 0; e < 16; ++e) qn = fmaf(qv[e], qv[e], qn);
#pragma unroll
        for (int t = 0; t < kRow8Slots; ++t) {
          const float st = __shfl_sync(kFull, sc, 4 * t + g);
          const uint32_t w[4] = {code[t].x, code[t].y, code[t].z, code[t].w};
          float v[16];
#pragma unroll
          for (int k = 0; k < 4; ++k) {   // v = code * scale, rounded once
            v[4 * k] = __fmul_rn(code_at<0>(w[k]), st);
            v[4 * k + 1] = __fmul_rn(code_at<1>(w[k]), st);
            v[4 * k + 2] = __fmul_rn(code_at<2>(w[k]), st);
            v[4 * k + 3] = __fmul_rn(code_at<3>(w[k]), st);
          }
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            dot[t] = fmaf(v[e], qv[e], dot[t]);
            vv[t] = fmaf(v[e], v[e], vv[t]);
          }
        }
      }
      const float dj = sum8_scatter(dot, sub);
      const float vj = sum8_scatter(vv, sub);
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) qn += __shfl_xor_sync(kFull, qn, o);
      const int c = cb + 4 * sub + g;
      if (c < C)
        out[(s * Kq + q) * C + c] =
            mine < 0 ? kInf : (ip ? -dj : (qn + vj) - 2.f * dj);
    }
  }
}

// --------------------------------------------------------------------------
// the bf16 row body: one warp a row s
// --------------------------------------------------------------------------

// Elements e and e + 1 of a row from `off` on as one word (e in the low
// half), zeros past d.
__device__ __forceinline__ uint32_t bf16_pair(const uint16_t* p, int off,
                                              int e, int d) {
  const uint32_t lo = off + e < d ? static_cast<uint32_t>(__ldg(p + e)) : 0u;
  const uint32_t hi =
      off + e + 1 < d ? static_cast<uint32_t>(__ldg(p + e + 1)) : 0u;
  return lo | hi << 16;
}

// 8 bf16 elements of a candidate row from element `off` on, as 4 words
// (element 2k in the low half of word k): one 16-byte load where rows and
// the base are 16-byte aligned (VEC: d % 8 == 0), else element by element;
// zeros past d and for a lane without a row (id < 0).
template <bool VEC>
__device__ __forceinline__ uint4 load_bf16(const uint16_t* X, int id, int off,
                                           int d) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (id < 0 || off >= d) return r;
  const uint16_t* p = X + static_cast<long long>(id) * d + off;
  if constexpr (VEC) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  } else {   // word by word: no array, nothing whose address is taken
    r = make_uint4(bf16_pair(p, off, 0, d), bf16_pair(p, off, 2, d),
                   bf16_pair(p, off, 4, d), bf16_pair(p, off, 6, d));
  }
  return r;
}

// 8 query floats from `off` on (zeros past d): two 16-byte loads (VEC) or
// one at a time.
template <bool VEC>
__device__ __forceinline__ void load_query8(const float* q, int off, int d,
                                            float (&v)[8]) {
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 a = off < d
          ? __ldg(reinterpret_cast<const float4*>(q + off) + j)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * j] = a.x;
      v[4 * j + 1] = a.y;
      v[4 * j + 2] = a.z;
      v[4 * j + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = off + e < d ? __ldg(q + off + e) : 0.f;
  }
}

// Warp w of a CTA owns row s = 8 * blockIdx.x + w.  Candidates go in
// blocks of 32 as in gather_row8_kernel: lane c holds candidate cb + c's
// id (-1: masked or out of range); lane g * 8 + j sums slots t = 0..7,
// candidate cb + 4t + g, over elements [8 j, 8 j + 8) of each 64-element
// pass of d, and ends with candidate cb + 4j + g's sums.  With d <= 64
// (one pass) the rows stay in registers across the Kq queries.  The
// minimum of one block an SM lets ptxas keep the element-wise body's 64
// loads in flight in registers (without it, it capped that body at 80
// registers and spilled 12 bytes; both bodies now take ~92 and none).
template <bool VEC>
__global__ void __launch_bounds__(kRowThreads, 1)
gather_rowbf16_kernel(const float* __restrict__ Q,
                      const uint16_t* __restrict__ X,
                      const int32_t* __restrict__ idx,
                      const uint8_t* __restrict__ mask,
                      float* __restrict__ out, int S, int Kq, int C, int d,
                      long long N, int ip) {
  constexpr unsigned kFull = 0xffffffffu;
  const long long s = static_cast<long long>(blockIdx.x) * (kRowThreads / 32)
                      + (threadIdx.x >> 5);
  if (s >= S) return;   // warp-uniform
  const int lane = threadIdx.x & 31, g = lane >> 3, sub = lane & 7;
  const int passes = (d + 63) >> 6;
  for (int cb = 0; cb < C; cb += 32) {
    int id = -1;
    if (cb + lane < C) {
      const long long lc = s * C + cb + lane;
      const int32_t raw = __ldg(idx + lc);
      if ((mask == nullptr || __ldg(mask + lc) != 0) && raw >= 0 && raw < N)
        id = raw;
    }
    int sid[kRow8Slots];
#pragma unroll
    for (int t = 0; t < kRow8Slots; ++t)
      sid[t] = __shfl_sync(kFull, id, 4 * t + g);
    const int mine = __shfl_sync(kFull, id, 4 * sub + g);
    uint4 row[kRow8Slots];
    for (int q = 0; q < Kq; ++q) {
      const float* qrow = Q + (s * Kq + q) * d;
      float dot[kRow8Slots] = {}, vv[kRow8Slots] = {}, qn = 0.f;
      for (int p = 0; p < passes; ++p) {
        const int off = p * 64 + sub * 8;
        if (q == 0 || passes > 1) {
#pragma unroll
          for (int t = 0; t < kRow8Slots; ++t)
            row[t] = load_bf16<VEC>(X, sid[t], off, d);
        }
        float qv[8];
        load_query8<VEC>(qrow, off, d, qv);
#pragma unroll
        for (int e = 0; e < 8; ++e) qn = fmaf(qv[e], qv[e], qn);
#pragma unroll
        for (int t = 0; t < kRow8Slots; ++t) {
          const uint32_t w[4] = {row[t].x, row[t].y, row[t].z, row[t].w};
          float v[8];
#pragma unroll
          for (int k = 0; k < 4; ++k) {   // bf16 -> fp32: the bits, shifted
            v[2 * k] = __uint_as_float(w[k] << 16);
            v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            dot[t] = fmaf(v[e], qv[e], dot[t]);
            vv[t] = fmaf(v[e], v[e], vv[t]);
          }
        }
      }
      const float dj = sum8_scatter(dot, sub);
      const float vj = sum8_scatter(vv, sub);
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) qn += __shfl_xor_sync(kFull, qn, o);
      const int c = cb + 4 * sub + g;
      if (c < C)
        out[(s * Kq + q) * C + c] =
            mine < 0 ? kInf : (ip ? -dj : (qn + vj) - 2.f * dj);
    }
  }
}

// --------------------------------------------------------------------------
// self-query tiles on tensor cores (3xTF32 mma.m16n8k8)
// --------------------------------------------------------------------------

// Rows [0, R) of d-chunk [d0, d0 + DC) into buf ([R][DC + 8] floats):
// 16-byte cp.async where every row is 16-byte aligned (VEC), else 4-byte;
// pad rows (rid < 0) and columns past d are zeros.  A warp copies one
// 512-byte row (DC = 128) per instruction.
template <bool VEC>
__device__ __forceinline__ void sq_stage(float* buf, const float* X,
                                         const int* rid, int R, int d,
                                         int d0, int lg_dc) {
  const int DC = 1 << lg_dc, LD = DC + 8;
  if constexpr (VEC) {
    const int lg = lg_dc - 2;                  // 16-byte pieces a row
    for (int e = threadIdx.x; e < (R << lg); e += kSqThreads) {
      const int r = e >> lg, c = (e & ((1 << lg) - 1)) * 4;
      const int id = rid[r];
      const bool ok = id >= 0 && d0 + c < d;
      cp_async16(buf + r * LD + c, ok ? X + (long long)id * d + d0 + c : X,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < (R << lg_dc); e += kSqThreads) {
      const int r = e >> lg_dc, c = e & (DC - 1);
      const int id = rid[r];
      const bool ok = id >= 0 && d0 + c < d;
      cp_async4(buf + r * LD + c, ok ? X + (long long)id * d + d0 + c : X,
                ok ? 4 : 0);
    }
  }
}

// norms[r] += the squares of staged row r, in fp32 FFMA (a warp a row)
__device__ __forceinline__ void sq_norms(const float* buf, float* norms,
                                         int R, int DC) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += kSqWarps) {
    const float* row = buf + r * (DC + 8);
    float acc = 0.f;
    for (int c = lane; c < DC; c += 32) acc += row[c] * row[c];
    acc = warp_sum(acc);
    if (lane == 0) norms[r] += acc;
  }
}

// acc[n] += one 8-column step of rows [m0, m0 + 16) . rows [n0 + 8n, +8)
// in 3xTF32, lo.hi + hi.lo + hi.hi (the small products first, each pass
// over independent tiles); ar and br point at the step's column 2t of
// rows m0 + g and n0 + g.  k-index t of a step is column 2t and t + 4 is
// 2t + 1, so each operand pair is one 8-byte load (row stride DC + 8 = 8
// mod 32 words: no bank conflict in a half-warp).
template <int NT>
__device__ __forceinline__ void sq_step(float (&acc)[NT][4], const float* ar,
                                        const float* br, int LD) {
  const float2 x0 = *reinterpret_cast<const float2*>(ar);
  const float2 x1 = *reinterpret_cast<const float2*>(ar + 8 * LD);
  uint32_t ah[4], al[4];
  split_tf32(x0.x, ah[0], al[0]);
  split_tf32(x1.x, ah[1], al[1]);
  split_tf32(x0.y, ah[2], al[2]);
  split_tf32(x1.y, ah[3], al[3]);
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 y = *reinterpret_cast<const float2*>(br + n * 8 * LD);
    split_tf32(y.x, bh[n][0], bl[n][0]);
    split_tf32(y.y, bh[n][1], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(acc[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(acc[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(acc[n], ah, bh[n][0], bh[n][1]);
}

// acc[n] += rows [m0, m0 + 16) . rows [n0 + 8n, n0 + 8n + 8) over the
// chunk's first 8 * ksteps columns
template <int NT>
__device__ __forceinline__ void sq_products(float (&acc)[NT][4],
                                            const float* buf, int LD, int m0,
                                            int n0, int ksteps) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float* ar = buf + (m0 + g) * LD + 2 * t4;
  const float* br = buf + (n0 + g) * LD + 2 * t4;
#pragma unroll 4
  for (int kk = 0; kk < ksteps; ++kk)
    sq_step<NT>(acc, ar + kk * 8, br + kk * 8, LD);
}

// The clipped ids (-1: a pad row), column validity and zeroed norms of
// the R staged rows of the group of tiles [s0, s0 + TPC)
__device__ __forceinline__ void sq_ids(const int32_t* idx, const uint8_t* mask,
                                       int* rid, int* rval, float* norms,
                                       long long s0, int S, int K, int KP,
                                       int TPC, int R, long long N) {
  for (int r = threadIdx.x; r < R; r += kSqThreads) {
    const int ts = r / KP, i = r - ts * KP;
    const long long s = s0 + ts;
    int id = -1, ok = 0;
    if (ts < TPC && i < K && s < S) {
      const int32_t raw = idx[s * K + i];
      ok = (mask == nullptr || mask[s * K + i] != 0) && raw >= 0 && raw < N;
      id = raw < 0 ? 0 : (raw >= N ? (int)(N - 1) : raw);
    }
    rid[r] = id;
    rval[r] = ok;
    norms[r] = 0.f;
  }
}

// A persistent CTA walks groups of TPC tiles s (KP = K rounded up to 16;
// TPC = 64 / KP for K <= 64, else 1), staging a group's rows (TPC * KP,
// padded with zero rows to R so that every warp's 8 * NT columns exist;
// NT = 4 for K <= 32, else 8) DC columns of d at a time.  ONE: d fits one chunk, and the next group's
// rows load into the second buffer while this group multiplies.  Else the
// two buffers are a ring of d-chunks, and each chunk sums into a fresh
// accumulator added to the running one rounded to nearest: the tensor
// cores' adder truncates, and over d = 960 its bias would pass the
// tolerance on the diagonal (up to 128 columns it stays under a third).
// Warp items are (tile, 16-row strip, 64-column block): with K <= 64 every
// warp owns one item; above, the warps walk their items in rounds, and
// for d > DC each round streams the chunks again.
template <int NT, bool VEC, bool ONE>
__global__ void __launch_bounds__(kSqThreads)
gather_selfq_kernel(const float* __restrict__ X,
                    const int32_t* __restrict__ idx,
                    const uint8_t* __restrict__ mask, float* __restrict__ out,
                    int S, int K, int KP, int TPC, int R, int d, int lg_dc,
                    long long N, int ip) {
  extern __shared__ __align__(16) float smem[];
  const int DC = 1 << lg_dc, LD = DC + 8;
  const int n_chunks = (d + DC - 1) / DC;
  const long long G = (S + TPC - 1) / TPC;
  float* rows = smem;                          // [2][R][LD]
  float* norms = rows + 2 * R * LD;            // [2][R]
  int* rid = reinterpret_cast<int*>(norms + 2 * R);   // [2][R]
  int* rval = rid + 2 * R;                     // [2][R] column validity
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int strips = KP / 16, blocks = (KP + 63) / 64;
  const int items = TPC * strips * blocks;
  if constexpr (ONE) {   // the first group's rows
    sq_ids(idx, mask, rid, rval, norms, blockIdx.x * (long long)TPC, S, K,
           KP, TPC, R, N);
    __syncthreads();
    sq_stage<VEC>(rows, X, rid, R, d, 0, lg_dc);
    cp_async_commit();
  }
  int cur = 0;   // the slot of this group's rows and ids
  for (long long g = blockIdx.x; g < G; g += gridDim.x) {
    const long long s0 = g * TPC, gn = g + gridDim.x;
    __syncthreads();   // the previous group is done with the other slot
    if constexpr (ONE) {
      const int nxt = cur ^ 1;
      if (gn < G)
        sq_ids(idx, mask, rid + nxt * R, rval + nxt * R, norms + nxt * R,
               gn * TPC, S, K, KP, TPC, R, N);
      cp_async_wait<0>();
      __syncthreads();
      if (gn < G)   // in flight while this group multiplies
        sq_stage<VEC>(rows + nxt * R * LD, X, rid + nxt * R, R, d, 0,
                      lg_dc);
      cp_async_commit();
      if (!ip) sq_norms(rows + cur * R * LD, norms + cur * R, R, DC);
    } else {
      sq_ids(idx, mask, rid, rval, norms, s0, S, K, KP, TPC, R, N);
    }
    __syncthreads();
    for (int base = 0; base < items; base += kSqWarps) {
      const int item = base + warp;
      const int nb = item % blocks, strip = (item / blocks) % strips;
      const int ts = item / (blocks * strips);
      const bool live = item < items && s0 + ts < S;
      const int m0 = ts * KP + 16 * strip, n0 = ts * KP + 64 * nb;
      float acc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      if constexpr (ONE) {
        if (live)
          sq_products<NT>(acc, rows + cur * R * LD, LD, m0, n0, (d + 7) / 8);
      } else {
        sq_stage<VEC>(rows, X, rid, R, d, 0, lg_dc);
        cp_async_commit();
        for (int ch = 0; ch < n_chunks; ++ch) {
          if (ch + 1 < n_chunks) {   // the next chunk loads while this runs
            sq_stage<VEC>(rows + ((ch + 1) & 1) * R * LD, X, rid, R, d,
                          (ch + 1) * DC, lg_dc);
            cp_async_commit();
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
          const float* buf = rows + (ch & 1) * R * LD;
          if (base == 0 && !ip) sq_norms(buf, norms, R, DC);
          if (live) {
            float part[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
            sq_products<NT>(part, buf, LD, m0, n0,
                            (min(DC, d - ch * DC) + 7) / 8);
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
          }
          __syncthreads();   // every read of this stage (and norm) is done
        }
      }
      if (!live) continue;
      // the formula and the column mask straight from the fragments: c0,
      // c1 are row g8, columns 2t and 2t + 1; c2, c3 the same on g8 + 8
      float* o = out + (s0 + ts) * K * K;
      const float* tn = norms + cur * R + ts * KP;
      const int* tv = rval + cur * R + ts * KP;
      const bool pairs = (K & 1) == 0;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int j = 64 * nb + 8 * n + 2 * t4;
        if (j >= K) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * strip + g8 + 8 * h;
          if (i >= K) continue;
          float x = acc[n][2 * h], y = acc[n][2 * h + 1];
          if (!ip) {
            x = (tn[i] + tn[j]) - 2.f * x;
            y = (tn[i] + tn[j + 1]) - 2.f * y;
          } else {
            x = -x;
            y = -y;
          }
          x = tv[j] ? x : kInf;
          y = tv[j + 1] ? y : kInf;
          float* p = o + (long long)i * K + j;
          if (pairs) {
            *reinterpret_cast<float2*>(p) = make_float2(x, y);
          } else {
            p[0] = x;
            if (j + 1 < K) p[1] = y;
          }
        }
      }
    }
    if constexpr (ONE) cur ^= 1;
  }
  cp_async_wait<0>();
}

// The launch plan of a self-query call; false if no chunk width fits.
struct SqPlan {
  int KP, TPC, R, lg_dc, nt;
  size_t smem;
  bool one;
};

bool sq_plan(int K, int d, SqPlan& p) {
  p.KP = (K + 15) / 16 * 16;
  p.TPC = p.KP < kSqRows ? kSqRows / p.KP : 1;
  p.nt = p.KP <= 32 ? 4 : 8;
  // rows for every warp's 8 * nt columns from its tile's first: columns
  // past K read the next tile's rows or zero rows, and are not stored
  const int blocks = (p.KP + 63) / 64;
  p.R = std::max(p.TPC * p.KP,
                 (p.TPC - 1) * p.KP + 64 * (blocks - 1) + 8 * p.nt);
  int dc = kSqMaxDc;
  while (dc > kSqMinDc && dc / 2 >= d) dc /= 2;   // d <= DC: one chunk
  for (;; dc /= 2) {   // two buffers of R rows, and three [R] arrays twice
    p.smem = sizeof(float) * 2 * p.R * (dc + 8) + sizeof(float) * 6 * p.R;
    if (p.smem <= kMaxSmem) break;
    if (dc == kSqMinDc) return false;
  }
  p.one = d <= dc;
  p.lg_dc = 0;
  while ((1 << p.lg_dc) < dc) ++p.lg_dc;
  return true;
}

template <int NT, bool VEC, bool ONE>
int launch_selfq(const float* x, const int32_t* ix, const uint8_t* m,
                 float* o, int S, int K, int d, long long N, int ip,
                 const SqPlan& p, cudaStream_t st) {
  auto kern = gather_selfq_kernel<NT, VEC, ONE>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // persistent: as many CTAs as X's card holds at once, or one a group
  cudaPointerAttributes pa;
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaPointerGetAttributes(&pa, x);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               pa.device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kSqThreads, p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long groups = (S + p.TPC - 1) / p.TPC;
  const long long grid = std::min<long long>(
      groups, static_cast<long long>(std::max(1, per_sm)) * sms);
  kern<<<static_cast<unsigned>(grid), kSqThreads, p.smem, st>>>(
      x, ix, m, o, S, K, p.KP, p.TPC, p.R, d, p.lg_dc, N, ip);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int dispatch_selfq(const float* x, const int32_t* ix, const uint8_t* m,
                   float* o, int S, int K, int d, long long N, int ip,
                   const SqPlan& p, cudaStream_t st) {
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec)
    return p.one ? launch_selfq<NT, true, true>(x, ix, m, o, S, K, d, N, ip,
                                                p, st)
                 : launch_selfq<NT, true, false>(x, ix, m, o, S, K, d, N, ip,
                                                 p, st);
  return p.one ? launch_selfq<NT, false, true>(x, ix, m, o, S, K, d, N, ip,
                                               p, st)
               : launch_selfq<NT, false, false>(x, ix, m, o, S, K, d, N, ip,
                                                p, st);
}

template <bool VEC>
void launch_rowq(const float* q, const float* x, const int32_t* ix,
                 const uint8_t* m, float* o, int S, int Kq, int C, int d,
                 long long N, int ip, cudaStream_t st) {
  gather_rowq_kernel<VEC><<<S, kRowThreads, 0, st>>>(q, x, ix, m, o, Kq, C,
                                                     d, N, ip);
}

template <bool VEC>
void launch_row8(const float* q, const int8_t* x, const float* sc,
                 const int32_t* ix, const uint8_t* m, float* o, int S,
                 int Kq, int C, int d, long long N, int ip,
                 cudaStream_t st) {
  constexpr int rows = kRowThreads / 32;
  gather_row8_kernel<VEC><<<(S + rows - 1) / rows, kRowThreads, 0, st>>>(
      q, x, sc, ix, m, o, S, Kq, C, d, N, ip);
}

template <bool VEC>
void launch_rowbf16(const float* q, const uint16_t* x, const int32_t* ix,
                    const uint8_t* m, float* o, int S, int Kq, int C, int d,
                    long long N, int ip, cudaStream_t st) {
  constexpr int rows = kRowThreads / 32;
  gather_rowbf16_kernel<VEC><<<(S + rows - 1) / rows, kRowThreads, 0, st>>>(
      q, x, ix, m, o, S, Kq, C, d, N, ip);
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
    SqPlan p;
    if (!sq_plan(C, d, p)) return static_cast<int>(cudaErrorInvalidValue);
    const float* x = static_cast<const float*>(X);
    return p.nt == 4
        ? dispatch_selfq<4>(x, ix, m, o, S, C, d, N, ip, p, st)
        : dispatch_selfq<8>(x, ix, m, o, S, C, d, N, ip, p, st);
  }
  const float* q = static_cast<const float*>(Q);
  if (sc != nullptr) {   // 16-byte code pieces and query loads
    const int8_t* x = static_cast<const int8_t*>(X);
    const bool vec = d % 16 == 0
        && reinterpret_cast<uintptr_t>(x) % 16 == 0
        && reinterpret_cast<uintptr_t>(q) % 16 == 0;
    if (vec) launch_row8<true>(q, x, sc, ix, m, o, S, Kq, C, d, N, ip, st);
    else launch_row8<false>(q, x, sc, ix, m, o, S, Kq, C, d, N, ip, st);
  } else {
    const float* x = static_cast<const float*>(X);
    const bool vec = d % 4 == 0
        && reinterpret_cast<uintptr_t>(x) % 16 == 0
        && reinterpret_cast<uintptr_t>(q) % 16 == 0;
    if (vec) launch_rowq<true>(q, x, ix, m, o, S, Kq, C, d, N, ip, st);
    else launch_rowq<false>(q, x, ix, m, o, S, Kq, C, d, N, ip, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// X is bf16 [N, d] (its raw 16-bit elements), Q float32 [S, Kq, d]: the
// bf16 row body.  16-byte pieces where d % 8 == 0 and X and Q are 16-byte
// aligned, else the element-wise body.
extern "C" int repro_gather_distances_bf16(const void* Q, const void* X,
                                           const void* idx, const void* mask,
                                           void* out, int S, int Kq, int C,
                                           int d, long long N, int ip,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 0 || C == 0) return static_cast<int>(cudaGetLastError());
  const float* q = static_cast<const float*>(Q);
  const uint16_t* x = static_cast<const uint16_t*>(X);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  const bool vec = d % 8 == 0
      && reinterpret_cast<uintptr_t>(x) % 16 == 0
      && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (vec) launch_rowbf16<true>(q, x, ix, m, o, S, Kq, C, d, N, ip, st);
  else launch_rowbf16<false>(q, x, ix, m, o, S, Kq, C, d, N, ip, st);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local (spilled) bytes a thread of each body, in the order
// of kernels/l2dist.py BODIES: the self-query bodies (NT = 4, 8 n-tiles a
// warp; 16-byte staging, then 4-byte; d in one chunk, then streamed), then
// the int8 row body (16-byte pieces, then bytes), then the bf16 row body
// (16-byte pieces, then elements).
extern "C" int repro_l2dist_attrs(int which, int* regs, int* local_bytes) {
#define REPRO_SELFQ_BODIES(VEC, ONE)                               \
  reinterpret_cast<const void*>(gather_selfq_kernel<4, VEC, ONE>), \
      reinterpret_cast<const void*>(gather_selfq_kernel<8, VEC, ONE>)
  static const void* const bodies[] = {
      REPRO_SELFQ_BODIES(true, true), REPRO_SELFQ_BODIES(false, true),
      REPRO_SELFQ_BODIES(true, false), REPRO_SELFQ_BODIES(false, false),
      reinterpret_cast<const void*>(gather_row8_kernel<true>),
      reinterpret_cast<const void*>(gather_row8_kernel<false>),
      reinterpret_cast<const void*>(gather_rowbf16_kernel<true>),
      reinterpret_cast<const void*>(gather_rowbf16_kernel<false>)};
#undef REPRO_SELFQ_BODIES
  constexpr int n = sizeof(bodies) / sizeof(bodies[0]);
  if (which < 0 || which >= n) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, bodies[which]);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
