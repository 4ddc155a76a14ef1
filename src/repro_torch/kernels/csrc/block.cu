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
// A second kernel serves the reference's dense kernel kernels/l2dist.py
// distance_matrix_pallas (_dist_kernel): Q [B, d] x X [N, d] -> out [B, N]
// float32, the same formula with no mask (repro_distance_matrix below), Q
// and X float32 or bfloat16 (widened to float32 as the reference's
// .astype(float32)).  Its full-size caller is the exact k-NN of 1,024
// queries against a 2^20 x 128 corpus: 275 GFLOP, 4.1 ms at 67 TFLOP/s on
// CUDA cores but 0.56 ms at the 495 TFLOP/s of the TF32 tensor cores,
// against 4.3 GB of output (1.28 ms at 3.35 TB/s).  So it runs on tensor
// cores (mma_tf32.cuh):
//   * float32: 3xTF32 mma.m16n8k8, x = hi + lo split as the fragments are
//     loaded, lo.hi + hi.lo + hi.hi into one float32 accumulator; a single
//     TF32 rounding misses the fp32 contract (1e-5 * (qn + xn)) many times
//     over, the split holds it.  The products issued are 3x the work:
//     825 GFLOP, 2.6 ms at mma.sync's ~313 TFLOP/s.  The tensor cores'
//     adder truncates, so each chunk sums into a fresh accumulator that is
//     added to the running one rounded to nearest;
//   * bf16: one mma.m16n8k16 with float32 accumulation from ldmatrix
//     fragments; a bf16 x bf16 product is exact in float32, so no split;
//   * one CTA of 8 warps (4 x 2, each 32 x 32 outputs) per 128 x 64 tile
//     and two CTAs an SM, d streamed in 128-byte chunks (32 float32 or 64
//     bf16 columns) through a three-stage cp.async ring; the query tiles
//     of one X tile run side by side, so X is read from device memory
//     about once (128 x 128 tiles of 64 x 32 a warp, one CTA an SM, were
//     slower at the exact k-NN's shape);
//   * the norms are fp32 FFMA sums of the staged chunks (one thread a row),
//     and the epilogue writes the formula from the accumulator fragments
//     with 8-byte streaming stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kTile = 64;     // output rows (Kq) and columns (C) per CTA
constexpr int kDc = 32;       // d chunk staged per step
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = kTile + 1;

template <bool QUANT>
__global__ void __launch_bounds__(kThreads)
block_kernel(const float* __restrict__ Q, const void* __restrict__ V,
             const float* __restrict__ v_scales,
             const uint8_t* __restrict__ mask, float* __restrict__ out,
             int S, int Kq, int C, int d, int ip) {
  __shared__ float qs[kDc][kPad];   // [k][row]
  __shared__ float vs[kDc][kPad];   // [k][col]
  __shared__ float qn_s[kTile], vn_s[kTile];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c0 = blockIdx.x * kTile, q0 = blockIdx.y * kTile;
  for (long long s = blockIdx.z; s < S; s += gridDim.z) {
    const float* qb = Q + s * Kq * d;
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
                       ? __ldg(qb + (long long)q * d + d0 + k) : 0.f;
        float v = 0.f;
        if (in_d && c < C) {
          const long long off = vb + (long long)c * d + d0 + k;
          if constexpr (QUANT) {
            v = __fmul_rn(
                static_cast<float>(static_cast<const int8_t*>(V)[off]),
                __ldg(v_scales + s * C + c));
          } else {
            v = __ldg(static_cast<const float*>(V) + off);
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

// --------------------------------------------------------------------------
// the dense distance matrix on tensor cores
// --------------------------------------------------------------------------

constexpr int kDmQRows = 128;             // CTA tile: 128 queries x
constexpr int kDmXRows = 64;              // ... 64 rows of X
constexpr int kDmWM = 4, kDmWN = 2;       // warps over the tile's rows, cols
constexpr int kDmWarps = kDmWM * kDmWN;
constexpr int kDmThreads = 32 * kDmWarps;
constexpr int kDmMI = kDmQRows / kDmWM / 16;   // m16 tiles a warp
constexpr int kDmNI = kDmXRows / kDmWN / 8;    // n8 tiles a warp
constexpr int kDmStages = 3;              // cp.async ring of d-chunks

template <typename T>
struct DmCfg {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int DC = 128 / sizeof(T);  // a chunk: 128 bytes a row
  static constexpr int VEC = 16 / sizeof(T);  // elements a 16-byte piece
  // row stride in elements: 8 mod 32 words for float32 (a thread's two
  // neighbours, 8-byte loads), 4 mod 32 for bf16 (ldmatrix rows)
  static constexpr int LD = DC + 8;
  static constexpr int kStage = (kDmQRows + kDmXRows) * LD;  // Q, then X
  static constexpr size_t kSmem = sizeof(T) * kDmStages * kStage
                                  + sizeof(float) * (kDmQRows + kDmXRows);
};

// rows [0, ROWS) of a d-chunk of a [rows][d] block into a padded tile;
// rows past `valid` and columns past d are zeros.  VEC: 16-byte cp.async,
// 8 threads a row (128 bytes, coalesced); else element by element.
template <typename T, bool VEC, int ROWS>
__device__ __forceinline__ void dm_stage(T* dst, const T* src, int valid,
                                         int d, int d0) {
  using C = DmCfg<T>;
  if constexpr (VEC) {
    constexpr int STEP = kDmThreads / 8;
    const int c = (threadIdx.x & 7) * C::VEC, r0 = threadIdx.x >> 3;
    const bool col_ok = d0 + c < d;
#pragma unroll
    for (int i = 0; i < ROWS / STEP; ++i) {
      const int r = r0 + STEP * i;
      const bool ok = col_ok && r < valid;
      cp_async16(dst + r * C::LD + c,
                 ok ? src + (long long)r * d + d0 + c : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * C::DC; e += kDmThreads) {
      const int r = e / C::DC, c = e % C::DC;
      dst[r * C::LD + c] = (r < valid && d0 + c < d)
                               ? src[(long long)r * d + d0 + c]
                               : static_cast<T>(0.f);
    }
  }
}

// the sum of squares of a staged chunk row, in fp32 FFMA: eight 16-byte
// pieces, float32 rows rotated by one piece in the second half of each
// quarter-warp so that its eight rows hit 32 different banks
template <typename T>
__device__ __forceinline__ float dm_norm(const T* row) {
  using C = DmCfg<T>;
  const int rot = C::kBf16 ? 0 : (threadIdx.x >> 2) & 1;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 v =
        *reinterpret_cast<const float4*>(row + ((j + rot) & 7) * C::VEC);
    if constexpr (C::kBf16) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        acc += f.x * f.x;
        acc += f.y * f.y;
      }
    } else {
      acc += v.x * v.x;
      acc += v.y * v.y;
      acc += v.z * v.z;
      acc += v.w * v.w;
    }
  }
  return acc;
}

// acc += Q tile rows [16 MI wm, +16 MI) . X tile rows [8 NI wn, +8 NI)
// over one chunk.  float32: 3xTF32 mma.m16n8k8, k-index t of a step
// column 2t and t + 4 column 2t + 1 (one 8-byte load a pair), hi and lo
// split as loaded.  bf16: mma.m16n8k16 from ldmatrix fragments (bf16
// products are exact in float32: no split).
template <typename T>
__device__ __forceinline__ void dm_products(float (&acc)[kDmMI][kDmNI][4],
                                            const T* qs, const T* xs,
                                            int wm, int wn) {
  using C = DmCfg<T>;
  constexpr int LD = C::LD, MI = kDmMI, NI = kDmNI;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  if constexpr (C::kBf16) {
#pragma unroll
    for (int kk = 0; kk < C::DC / 16; ++kk) {
      uint32_t a[MI][4], b[NI / 2][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldsm_x4(a[mi], qs + (16 * (MI * wm + mi) + (lane & 15)) * LD +
                           kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nn = 0; nn < NI / 2; ++nn)
        ldsm_x4(b[nn], xs + (8 * NI * wn + 16 * nn + (lane >> 4) * 8 +
                             (lane & 7)) * LD +
                           kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nn = 0; nn < NI / 2; ++nn) {
          mma_bf16(acc[mi][2 * nn], a[mi], b[nn][0], b[nn][1]);
          mma_bf16(acc[mi][2 * nn + 1], a[mi], b[nn][2], b[nn][3]);
        }
    }
  } else {
    const float* qa = qs + (16 * MI * wm + g) * LD + 2 * t4;
    const float* xb = xs + (8 * NI * wn + g) * LD + 2 * t4;
#pragma unroll
    for (int kk = 0; kk < C::DC / 8; ++kk) {
      uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const float* r = qa + 16 * mi * LD + kk * 8;
        const float2 x0 = *reinterpret_cast<const float2*>(r);
        const float2 x1 = *reinterpret_cast<const float2*>(r + 8 * LD);
        split_tf32(x0.x, ah[mi][0], al[mi][0]);
        split_tf32(x1.x, ah[mi][1], al[mi][1]);
        split_tf32(x0.y, ah[mi][2], al[mi][2]);
        split_tf32(x1.y, ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const float2 y =
            *reinterpret_cast<const float2*>(xb + 8 * ni * LD + kk * 8);
        split_tf32(y.x, bh[ni][0], bl[ni][0]);
        split_tf32(y.y, bh[ni][1], bl[ni][1]);
      }
      // the small products first, each pass over independent tiles
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_tf32(acc[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_tf32(acc[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_tf32(acc[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
    }
  }
}

// One CTA per 128 x 64 output tile, two CTAs an SM (128 registers a
// thread, 92 KB of shared memory), so one CTA's epilogue runs beside the
// other's products; the grid runs the q_tiles query tiles of one X column
// tile next to each other, so X is read from device memory about once and
// Q stays in L2.  d streams through a kDmStages cp.async ring of 128-byte
// chunks, the next chunks loading while this one multiplies.  Thread
// r < 128 sums the norm of the Q tile's row r, thread 128 + r that of the
// X tile's row r, from the staged chunks.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kDmThreads, 2)
dm_kernel(const T* __restrict__ Q, const T* __restrict__ X,
          float* __restrict__ out, int B, int N, int d, int q_tiles,
          int ip) {
  using C = DmCfg<T>;
  constexpr int MI = kDmMI, NI = kDmNI;
  extern __shared__ __align__(16) unsigned char dm_smem[];
  T* tiles = reinterpret_cast<T*>(dm_smem);   // [stage][Q rows | X rows][LD]
  float* qn_s = reinterpret_cast<float*>(tiles + kDmStages * C::kStage);
  float* xn_s = qn_s + kDmQRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp / kDmWN, wn = warp % kDmWN;
  const int q0 = (blockIdx.x % q_tiles) * kDmQRows;
  const int n0 = (blockIdx.x / q_tiles) * kDmXRows;
  const T* qt = Q + (long long)q0 * d;
  const T* xt = X + (long long)n0 * d;
  const int qv = B - q0, xv = N - n0;
  const int n_chunks = (d + C::DC - 1) / C::DC;
  const bool norm_row = !ip && tid < kDmQRows + kDmXRows;

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  float nacc = 0.f;

#pragma unroll
  for (int c = 0; c < kDmStages - 1; ++c) {
    if (c < n_chunks) {
      T* st = tiles + c * C::kStage;
      dm_stage<T, VEC, kDmQRows>(st, qt, qv, d, c * C::DC);
      dm_stage<T, VEC, kDmXRows>(st + kDmQRows * C::LD, xt, xv, d,
                                 c * C::DC);
    }
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<kDmStages - 2>();
    __syncthreads();   // chunk ch is in; every read of the slot refilled
    const int nxt = ch + kDmStages - 1;
    if (nxt < n_chunks) {
      T* st = tiles + (nxt % kDmStages) * C::kStage;
      dm_stage<T, VEC, kDmQRows>(st, qt, qv, d, nxt * C::DC);
      dm_stage<T, VEC, kDmXRows>(st + kDmQRows * C::LD, xt, xv, d,
                                 nxt * C::DC);
    }
    cp_async_commit();
    const T* qs = tiles + (ch % kDmStages) * C::kStage;
    const T* xs = qs + kDmQRows * C::LD;
    if (norm_row) nacc += dm_norm<T>(qs + tid * C::LD);   // X rows follow
    // a fresh accumulator a chunk, added to acc rounded to nearest: the
    // tensor cores' adder truncates, and its bias would grow with d
    float part[MI][NI][4] = {};
    dm_products<T>(part, qs, xs, wm, wn);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  }
  cp_async_wait<0>();
  if (norm_row) qn_s[tid] = nacc;   // xn_s = qn_s + 128
  __syncthreads();

  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = 16 * (MI * wm + mi) + g + 8 * h;
      if (lr >= qv) continue;
      float* orow = out + (long long)(q0 + lr) * N;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int lc = 8 * (NI * wn + ni) + 2 * t4;
        if (lc >= xv) continue;
        float x = acc[mi][ni][2 * h], y = acc[mi][ni][2 * h + 1];
        if (ip) {
          x = -x;
          y = -y;
        } else {
          x = (qn_s[lr] + xn_s[lc]) - 2.f * x;
          y = (qn_s[lr] + xn_s[lc + 1]) - 2.f * y;
        }
        float* p = orow + n0 + lc;
        if (pairs) {
          __stcs(reinterpret_cast<float2*>(p), make_float2(x, y));
        } else {
          __stcs(p, x);
          if (lc + 1 < xv) __stcs(p + 1, y);
        }
      }
    }
}

template <typename T>
int launch_dm(const void* Q, const void* X, float* out, int B, int N, int d,
              int ip, cudaStream_t st) {
  using C = DmCfg<T>;
  const T* q = static_cast<const T*>(Q);
  const T* x = static_cast<const T*>(X);
  const bool vec = d % C::VEC == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kern = vec ? dm_kernel<T, true> : dm_kernel<T, false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long q_tiles = (B + kDmQRows - 1) / kDmQRows;
  const long long tiles = q_tiles * ((N + kDmXRows - 1) / kDmXRows);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(tiles), kDmThreads, C::kSmem, st>>>(
      q, x, out, B, N, d, static_cast<int>(q_tiles), ip);
  return static_cast<int>(cudaGetLastError());
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
    block_kernel<true><<<grid, kThreads, 0, st>>>(q, V, sc, m, o, S, Kq, C,
                                                  d, ip);
  } else {
    block_kernel<false><<<grid, kThreads, 0, st>>>(q, V, sc, m, o, S, Kq, C,
                                                   d, ip);
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
  float* o = static_cast<float*>(out);
  return bf16 ? launch_dm<__nv_bfloat16>(Q, X, o, B, N, d, ip, st)
              : launch_dm<float>(Q, X, o, B, N, d, ip, st);
}

// Registers and local (spilled) bytes a thread of distance-matrix body
// `which`, in the order of kernels/block.py DM_BODIES: float32 with
// 16-byte staging, float32 element-wise, bf16 16-byte, bf16 element-wise.
extern "C" int repro_block_attrs(int which, int* regs, int* local_bytes) {
  static const void* const bodies[] = {
      reinterpret_cast<const void*>(dm_kernel<float, true>),
      reinterpret_cast<const void*>(dm_kernel<float, false>),
      reinterpret_cast<const void*>(dm_kernel<__nv_bfloat16, true>),
      reinterpret_cast<const void*>(dm_kernel<__nv_bfloat16, false>)};
  constexpr int n = sizeof(bodies) / sizeof(bodies[0]);
  if (which < 0 || which >= n) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, bodies[which]);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
