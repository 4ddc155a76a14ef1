// Distance tiles for Hopper (sm_90a): the distance block over pre-gathered
// rows and the dense distance matrix, one tensor-core tile.
//
// Replaces two TPU kernels of the reference, kernels/l2dist.py:
//   * block_distances_pallas (bodies _block_kernel, _block_kernel_quant):
//     Q [S, Kq, d] float32 x V [S, C, d] float32 (or int8 codes with
//     v_scales [S, C] float32) x mask [S, C] (0 -> 3.4e38) -> [S, Kq, C];
//   * distance_matrix_pallas (_dist_kernel): Q [B, d] x X [N, d] -> out
//     [B, N], float32 or bfloat16 inputs (widened to float32 as the
//     reference's .astype(float32)), no mask: the block with S = 1.
//
//   out = qn + vn - 2 <q, v>   (l2)      out = -<q, v>   (ip / cos)
//
// The int8 body dequantizes while it stages, v = float(code) * scale
// (rounded once, as the reference's widen-then-scale), and vn is taken over
// the dequantized values.
//
// Callers and bounds on the H100 (3.35 TB/s; TF32 tensor cores 495
// TFLOP/s, fp32 outside them 67; mma.sync issues TF32 products at ~313):
//   * the scan of the streaming delta shard (hotpath.scan_distances): S = 1,
//     Kq = 10240 queries, C = 16384 slots, d = 128.  42.9 GFLOP and 685 MB,
//     671 MB of it the output: bytes 0.204 ms, TF32 rate 0.087 ms, the 3x
//     products issued 0.412 ms, the fp32 rate outside the tensor cores
//     0.641 ms;
//   * the exact k-NN of 1,024 queries against a 2^20 x 128 corpus: 275
//     GFLOP and 4.3 GB of output: bytes 1.28 ms, TF32 0.56, issued 2.6.
// Both have d = 128 and an output that dominates the bytes: the same GEMM
// shape.  So one tile serves both, on tensor cores (mma_tf32.cuh):
//   * float32 operands: 3xTF32 mma.m16n8k8, x = hi + lo split as the
//     fragments are loaded, lo.hi + hi.lo + hi.hi into one float32
//     accumulator; a single TF32 rounding misses the fp32 contract
//     (1e-5 * (qn + vn)) many times over, the split holds it.  The tensor
//     cores' adder truncates, so each chunk sums into a fresh accumulator
//     that is added to the running one rounded to nearest;
//   * bfloat16 (matrix only): one mma.m16n8k16 with float32 accumulation
//     from ldmatrix fragments; a bf16 x bf16 product is exact in float32;
//   * int8 codes (block only): the codes are dequantized into the same
//     float32 ring as they are staged, so the products and norms are the
//     float32 body's.  cp.async cannot convert: each thread's 16-byte
//     ld.global.nc of the codes of chunk ch + 2 is issued before chunk ch's
//     products and written out (code x scale, four float4 stores) after
//     them, so the products hide the load as the ring does for float32;
//   * one CTA of 8 warps (4 x 2, each 32 x 32 outputs) per 128 x 64 tile
//     and two CTAs an SM, d streamed in 128-byte chunks (32 float32 or 64
//     bf16 columns) through a three-stage cp.async ring; the query tiles of
//     one V tile run side by side in blockIdx.x, so V is read from device
//     memory about once and Q stays in L2; blockIdx.y is the row s of the
//     block (a grid a 65,535 rows);
//   * the norms are fp32 FFMA sums of the staged chunks (one thread a row),
//     the threads left over flag the tile's masked V rows in shared memory,
//     and the epilogue writes the formula (3.4e38 where masked) from the
//     accumulator fragments with 8-byte streaming stores.
// Rows that are not 16-byte pieces (d % 4 for float32, d % 8 for bf16,
// d % 16 for int8 codes) or not 16-byte aligned stage element by element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kDmQRows = 128;             // CTA tile: 128 queries x
constexpr int kDmXRows = 64;              // ... 64 rows of V (X)
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
                                  + sizeof(float) * (kDmQRows + kDmXRows)
                                  + kDmXRows;   // masked flags of V rows
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

// int8 codes of a 64-row V tile, 32 columns a chunk (one float32 chunk):
// thread t < 128 takes row t / 2, columns 16 (t % 2) .. + 16, as one
// 16-byte piece.  i8_fetch loads it (zeros past `valid` rows and past d),
// i8_put writes it dequantized into the ring, code x scale rounded once.
__device__ __forceinline__ int4 i8_fetch(const int8_t* src, int valid, int d,
                                         int d0) {
  const int r = threadIdx.x >> 1, c = (threadIdx.x & 1) * 16;
  int4 v = make_int4(0, 0, 0, 0);
  if (threadIdx.x < 2 * kDmXRows && r < valid && d0 + c < d) {
    asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(src + (long long)r * d + d0 + c));
  }
  return v;
}

__device__ __forceinline__ float4 i8_dequant(int w, float scale) {
  return make_float4(
      __fmul_rn(static_cast<float>(static_cast<int8_t>(w)), scale),
      __fmul_rn(static_cast<float>(static_cast<int8_t>(w >> 8)), scale),
      __fmul_rn(static_cast<float>(static_cast<int8_t>(w >> 16)), scale),
      __fmul_rn(static_cast<float>(w >> 24), scale));
}

__device__ __forceinline__ void i8_put(float* dst, const int4& v,
                                       float scale) {
  if (threadIdx.x >= 2 * kDmXRows) return;
  const int r = threadIdx.x >> 1, c = (threadIdx.x & 1) * 16;
  float4* p = reinterpret_cast<float4*>(dst + r * DmCfg<float>::LD + c);
  p[0] = i8_dequant(v.x, scale);
  p[1] = i8_dequant(v.y, scale);
  p[2] = i8_dequant(v.z, scale);
  p[3] = i8_dequant(v.w, scale);
}

// the element-wise int8 staging, for rows that are not 16-byte pieces;
// rolled: unrolled, its loads in flight spill the body's registers
__device__ __forceinline__ void i8_stage(float* dst, const int8_t* src,
                                         const float* scales, int valid,
                                         int d, int d0) {
  using C = DmCfg<float>;
#pragma unroll 1
  for (int e = threadIdx.x; e < kDmXRows * C::DC; e += kDmThreads) {
    const int r = e / C::DC, c = e % C::DC;
    dst[r * C::LD + c] =
        (r < valid && d0 + c < d)
            ? __fmul_rn(static_cast<float>(src[(long long)r * d + d0 + c]),
                        __ldg(scales + r))
            : 0.f;
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

// One CTA per 128 x 64 output tile of a row s, two CTAs an SM (128
// registers a thread, 92 KB of shared memory), so one CTA's epilogue runs
// beside the other's products.  blockIdx.x is the tile, its q_tiles query
// tiles of one V tile next to each other; blockIdx.y is the row s.  d
// streams through a kDmStages ring of 128-byte chunks, the next chunks
// loading while this one multiplies.  Thread r < 128 sums the norm of the
// Q tile's row r, thread 128 + r that of the V tile's row r, from the
// staged chunks.  I8: X holds int8 codes (T float32), dequantized with
// v_scales as they are staged.
template <typename T, bool VEC, bool I8>
__global__ void __launch_bounds__(kDmThreads, 2)
dm_kernel(const T* __restrict__ Q, const void* __restrict__ Xv,
          const float* __restrict__ v_scales,
          const uint8_t* __restrict__ mask, float* __restrict__ out, int B,
          int N, int d, int q_tiles, int ip) {
  using C = DmCfg<T>;
  using TX = typename std::conditional<I8, int8_t, T>::type;
  static_assert(!I8 || !C::kBf16, "int8 codes stage as float32");
  constexpr int MI = kDmMI, NI = kDmNI;
  extern __shared__ __align__(16) unsigned char dm_smem[];
  T* tiles = reinterpret_cast<T*>(dm_smem);   // [stage][Q rows | X rows][LD]
  float* qn_s = reinterpret_cast<float*>(tiles + kDmStages * C::kStage);
  float* xn_s = qn_s + kDmQRows;
  uint8_t* dead_s = reinterpret_cast<uint8_t*>(xn_s + kDmXRows);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp / kDmWN, wn = warp % kDmWN;
  const int q0 = (blockIdx.x % q_tiles) * kDmQRows;
  const int n0 = (blockIdx.x / q_tiles) * kDmXRows;
  const int qv = B - q0, xv = N - n0;
  const int n_chunks = (d + C::DC - 1) / C::DC;
  const bool norm_row = !ip && tid < kDmQRows + kDmXRows;
  const bool pairs = (N & 1) == 0;
  const long long s = blockIdx.y;
  const T* qt = Q + (s * B + q0) * d;
  const TX* xt = static_cast<const TX*>(Xv) + (s * N + n0) * d;
  const float* sc = I8 ? v_scales + s * N + n0 : nullptr;
  // int8, 16-byte pieces: the scale of this thread's row, loaded once
  float scale = 0.f;
  if constexpr (I8 && VEC) {
    if (tid < 2 * kDmXRows && (tid >> 1) < xv)
      scale = __ldg(sc + (tid >> 1));
  }
  // chunk c of V into the ring slot st (int8 codes: synchronously)
  auto stage_x = [&](T* st, int c) {
    T* dst = st + kDmQRows * C::LD;
    if constexpr (!I8) {
      dm_stage<T, VEC, kDmXRows>(dst, xt, xv, d, c * C::DC);
    } else if constexpr (VEC) {
      i8_put(dst, i8_fetch(xt, xv, d, c * C::DC), scale);
    } else {
      i8_stage(dst, xt, sc, xv, d, c * C::DC);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  float nacc = 0.f;
  // threads 192-255 (no norm to sum) flag the tile's masked V rows
  if (mask != nullptr && tid >= kDmQRows + kDmXRows) {
    const int c = tid - (kDmQRows + kDmXRows);
    dead_s[c] = c < xv && mask[s * N + n0 + c] == 0;
  }

#pragma unroll
  for (int c = 0; c < kDmStages - 1; ++c) {
    if (c < n_chunks) {
      T* st = tiles + c * C::kStage;
      dm_stage<T, VEC, kDmQRows>(st, qt, qv, d, c * C::DC);
      stage_x(st, c);
    }
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<kDmStages - 2>();
    __syncthreads();   // chunk ch is in; every read of the slot refilled
    const int nxt = ch + kDmStages - 1;
    T* nst = tiles + (nxt % kDmStages) * C::kStage;
    int4 codes = make_int4(0, 0, 0, 0);   // int8 pieces of chunk nxt
    if (nxt < n_chunks) {
      dm_stage<T, VEC, kDmQRows>(nst, qt, qv, d, nxt * C::DC);
      if constexpr (I8 && VEC) {
        codes = i8_fetch(xt, xv, d, nxt * C::DC);
      } else {
        stage_x(nst, nxt);
      }
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
    if constexpr (I8 && VEC) {   // the slot's last reader was chunk ch - 1
      if (nxt < n_chunks) i8_put(nst + kDmQRows * C::LD, codes, scale);
    }
  }
  cp_async_wait<0>();
  if (norm_row) qn_s[tid] = nacc;   // xn_s = qn_s + 128
  __syncthreads();

  // The epilogue, compiled twice: with the mask, and without it for the
  // dense matrix, which one shared epilogue made 3-5% slower for bf16.
  auto epilogue = [&](auto masked) {
    // bit 2 ni + e: column 8 (NI wn + ni) + 2 t4 + e of the tile is masked
    unsigned dead = 0;
    if constexpr (decltype(masked)::value) {
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int lc = 8 * (NI * wn + ni) + 2 * t4;
        dead |= (dead_s[lc] | dead_s[lc + 1] << 1) << (2 * ni);
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = 16 * (MI * wm + mi) + g + 8 * h;
        if (lr >= qv) continue;
        float* orow = out + (s * B + q0 + lr) * N + n0;
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
          if constexpr (decltype(masked)::value) {
            if (dead & (1u << (2 * ni))) x = kInf;
            if (dead & (2u << (2 * ni))) y = kInf;
          }
          float* p = orow + lc;
          if (pairs) {
            __stcs(reinterpret_cast<float2*>(p), make_float2(x, y));
          } else {
            __stcs(p, x);
            if (lc + 1 < xv) __stcs(p + 1, y);
          }
        }
      }
  };
  if (mask != nullptr) {
    epilogue(std::true_type());
  } else {
    epilogue(std::false_type());
  }
}

// Launch the tile over S rows of [B, d] x [N, d]: T float32 or bf16 for
// both operands, or (I8) float32 queries and int8 codes with v_scales.  A
// grid takes up to 65,535 rows s in blockIdx.y; more rows take more grids.
template <typename T, bool I8>
int launch_dm(const void* Q, const void* X, const float* v_scales,
              const uint8_t* mask, float* out, int S, int B, int N, int d,
              int ip, cudaStream_t st) {
  using C = DmCfg<T>;
  using TX = typename std::conditional<I8, int8_t, T>::type;
  const T* q = static_cast<const T*>(Q);
  const TX* x = static_cast<const TX*>(X);
  const int piece = I8 ? 16 : C::VEC;   // elements of X a 16-byte piece
  const bool vec = d % piece == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kern = vec ? dm_kernel<T, true, I8> : dm_kernel<T, false, I8>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // the caller holds q_tiles x (V tiles) to the grid's 2^31 - 1
  const long long q_tiles = (B + kDmQRows - 1) / kDmQRows;
  const long long tiles = q_tiles * ((N + kDmXRows - 1) / kDmXRows);
  for (long long s0 = 0; s0 < S; s0 += 65535) {
    const int rows = static_cast<int>(S - s0 < 65535 ? S - s0 : 65535);
    kern<<<dim3(static_cast<unsigned>(tiles), rows), kDmThreads, C::kSmem,
           st>>>(q + s0 * B * d, x + s0 * N * d,
                 v_scales == nullptr ? nullptr : v_scales + s0 * N,
                 mask == nullptr ? nullptr : mask + s0 * N, out + s0 * B * N,
                 B, N, d, static_cast<int>(q_tiles), ip);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
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
  const float* sc = static_cast<const float*>(v_scales);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  return sc != nullptr
             ? launch_dm<float, true>(Q, V, sc, m, o, S, Kq, C, d, ip, st)
             : launch_dm<float, false>(Q, V, sc, m, o, S, Kq, C, d, ip, st);
}

// Dense distance matrix: Q [B, d] x X [N, d] -> out [B, N] float32, both
// inputs float32 (bf16 == 0) or bfloat16 (bf16 == 1).
extern "C" int repro_distance_matrix(const void* Q, const void* X, void* out,
                                     int B, int N, int d, int ip, int bf16,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  float* o = static_cast<float*>(out);
  return bf16 ? launch_dm<__nv_bfloat16, false>(Q, X, nullptr, nullptr, o, 1,
                                               B, N, d, ip, st)
              : launch_dm<float, false>(Q, X, nullptr, nullptr, o, 1, B, N,
                                        d, ip, st);
}

// The tile's shape, query rows x rows of V, for the wrapper's grid check.
extern "C" void repro_block_tile(int* rows, int* cols) {
  *rows = kDmQRows;
  *cols = kDmXRows;
}

// Registers and local (spilled) bytes a thread of tile body `which`, in
// the order of kernels/block.py DM_BODIES: float32 with 16-byte staging,
// float32 element-wise, bf16 16-byte, bf16 element-wise, int8 codes
// 16-byte, int8 codes element-wise.
extern "C" int repro_block_attrs(int which, int* regs, int* local_bytes) {
  static const void* const bodies[] = {
      reinterpret_cast<const void*>(dm_kernel<float, true, false>),
      reinterpret_cast<const void*>(dm_kernel<float, false, false>),
      reinterpret_cast<const void*>(dm_kernel<__nv_bfloat16, true, false>),
      reinterpret_cast<const void*>(dm_kernel<__nv_bfloat16, false, false>),
      reinterpret_cast<const void*>(dm_kernel<float, true, true>),
      reinterpret_cast<const void*>(dm_kernel<float, false, true>)};
  constexpr int n = sizeof(bodies) / sizeof(bodies[0]);
  if (which < 0 || which >= n) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, bodies[which]);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
