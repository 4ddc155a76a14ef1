// Packed SpMM for Hopper (sm_90a): a fixed-degree neighbour gather, its
// sum or mean, and the product with W.
//
// Replaces the reference's TPU kernel kernels/segment_matmul.py
// packed_spmm_pallas (_spmm_kernel):
//   agg[i] = sum over t < M with nbrs[i, t] < Nf of feat[max(nbrs[i, t], 0)]
//   agg[i] = agg[i] / max(cnt_i, 1)                            (mean)
//   out[i] = agg[i] @ W
// neighbors [N, M] int32, feat [Nf, d] float32 or bf16, W [d, f] float32
// -> out [N, f] in feat's type.  Ids >= Nf are sentinels and
// skipped; a negative id reads row 0 and counts, as the reference's plain
// path clips it.  The product with W is inside the TPU kernel's body, so
// both routes below compute it themselves.  bf16 feat is widened to fp32
// as it is read (the reference's .astype(float32) of each row; the
// wrapper widens a bf16 W once), every sum and product runs in fp32, and a bf16 output is rounded
// once, to nearest even, on its store: the transform route keeps Y in
// fp32 and rounds only the gathered output.
//
// The product is linear, so (sum_t feat[n_t]) @ W / cnt equals
// sum_t (feat[n_t] @ W) / cnt: the aggregate can come first (gather rows
// of d floats) or the product (gather rows of f floats).  Two routes,
// chosen by kernels/segment_matmul.py path() from the shapes alone; each
// launch modelled as max(bytes / 3.35 TB/s, products / rate), all N * M
// lanes counted:
//   * "fused", spmm_kernel, one launch: the gather, the sum in fp32 in the
//     order t = 0 .. M-1 from zero (a skipped lane adding 0.0), the mean
//     by __fdiv_rn, then the product in fp32 FFMA, the [64, 32] aggregate
//     chunk kept in shared memory.  Bytes N M (4 + 4 d) once per
//     128-column tile of the output, + 4 d f + 4 N f; products 2 N d f at
//     67 TFLOP/s.  It wins where Nf >> N (a minibatch over the whole
//     table) or f >= d.
//   * "transform", two launches: project_kernel, Y = feat @ W [Nf, f] on
//     the 3xTF32 tensor-core tile (bytes 4 Nf d + 4 d f + 4 Nf f;
//     products 3 x 2 Nf d f issued at mma.sync's ~313 TFLOP/s), then
//     gather_kernel, out[i] = the sum of Y's rows in the order t = 0 ..
//     M-1 from zero (a skipped lane adding 0.0), divided by max(cnt, 1)
//     with __fdiv_rn for the mean (bytes N M (4 + 4 f) + 4 N f).
// At GraphSAGE's first layer on Reddit (N = Nf = 232,965, M = 15, d = 602,
// f = 128, mean) the fused route reads 8.4 GB of 2,408-byte rows (2.5 ms)
// and the transform route 0.68 GB for Y (0.34 ms of issued products) and
// 1.9 GB of 512-byte rows (0.57 ms).
//
// project_kernel, block.cu's tile without its norms: one CTA of 8 warps
// (2 x 4, each 32 x 32 outputs) per 64 rows of feat x all of f <= 128
// columns, so feat is read once, two CTAs an SM; d streams through a
// three-stage cp.async ring of 32-column chunks.  fp32 feat's rows are staged
// in the widest cp.async piece their alignment allows (16, 8 or 4 bytes:
// at d = 602 a row is 2,408 bytes, 8-byte aligned), W's [32, 128] chunk
// k-major in 16-byte pieces; an operand that cannot take them (W's rows
// not 16-byte aligned, or feat's not 8) takes the body that stages both
// in 4-byte pieces: three bodies, each within 128 registers.  A bf16
// feat (two more bodies, by W's piece) is read element by element,
// each thread's elements loaded before any is widened and stored into the
// same fp32 ring slot, so the tile and its products are unchanged; a
// bf16 element widened to fp32 is one TF32 hi with lo = 0.  Y is stored
// in fp32 or, for project() called alone, in bf16.  x = hi + lo is split as the fragments
// load, lo.hi + hi.lo + hi.hi into one float32 accumulator; the tensor
// cores' adder truncates, so each chunk sums into a fresh accumulator that
// is added to the running one rounded to nearest.  Y is stored with plain
// stores, so the gather that follows finds part of it in L2.
//
// gather_kernel: one warp per output row and 128-column tile, each lane a
// float4 of the tile (f % 4 == 0 and 16-byte aligned; else 4 columns 32
// apart); the row's ids are loaded once, one a lane, and shuffled out;
// up to kBatch row loads are in flight before the adds; the output is
// stored in fp32 or bf16.
//
// The gradient (segment_matmul_bwd.cu) takes both on listed rows, their
// count on the card: repro_spmm_project_rows copies the listed rows of a
// float32 operand together (copy_rows_kernel) and projects them, its grid
// sized by the bound and its CTAs past the count returning at once;
// repro_spmm_gather_rows gathers the listed rows of the neighbour matrix.
// A row's result is the same either way: each output row depends on its
// own input row alone.
//
// Bytes of the bf16 bodies: 2 a feat element and (for bf16) an output
// element, so the bounds above halve where feat's rows dominate.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

// a bf16 element (its raw 16 bits) widened to fp32: the top half of the
// float32's bits
__device__ __forceinline__ float widen(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}
__device__ __forceinline__ uint16_t to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float load_elem(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_elem(const uint16_t* p) {
  return widen(__ldg(p));
}
__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(uint16_t* p, float x) {
  *p = to_bf16(x);
}

// ---- "fused": the gather, the mean and the FFMA product in one body ------

constexpr int kRows = 64;      // output rows per CTA
constexpr int kCols = 128;     // output columns per CTA
constexpr int kDc = 32;        // d chunk per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 8 outputs each
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 16;     // neighbour rows read before the adds

// TF: float (fp32 feat and output) or uint16_t (bf16's raw elements)
template <typename TF>
__global__ void __launch_bounds__(kThreads)
spmm_kernel(const int32_t* __restrict__ nbrs, const TF* __restrict__ feat,
            const float* __restrict__ w, TF* __restrict__ out, int N,
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
            if (id >= 0) v[u] = load_elem(feat + (long long)id * d + k);
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
    TF* orow = out + r * f;
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = f0 + tx + 16 * j;
      if (c < f) store_elem(orow + c, acc[i][j]);
    }
  }
}

// ---- "transform" (a): Y = feat @ W on the 3xTF32 tile ---------------------

constexpr int kPRows = 64;                 // feat rows a CTA
constexpr int kPCols = 128;                // output columns a CTA
constexpr int kPWM = 2, kPWN = 4;          // warps over rows, columns
constexpr int kPThreads = 32 * kPWM * kPWN;
constexpr int kPMI = kPRows / kPWM / 16;   // m16 tiles a warp
constexpr int kPNI = kPCols / kPWN / 8;    // n8 tiles a warp
constexpr int kPDc = 32;                   // d chunk: 128 bytes of a row
constexpr int kPStages = 3;                // cp.async ring of d chunks
// feat rows: 8 mod 32 words (a thread's two neighbours, 8-byte loads);
// W rows: 4 mod 32, so rows 2t and 2t + 1 of a fragment hit 32 banks
constexpr int kPLdA = kPDc + 8;
constexpr int kPLdB = kPCols + 4;
constexpr int kPStage = kPRows * kPLdA + kPDc * kPLdB;   // feat, then W
constexpr size_t kPSmem = sizeof(float) * kPStages * kPStage;

// a [ROWS, COLS] tile of a row-major source (row stride `stride`) into
// shared memory (row stride `ld`) in BYTES-wide cp.async pieces; rows past
// `valid` and columns past `cvalid` are zeros (no piece straddles cvalid).
// A thread takes one column piece c of rows r, r + STEP, ...: its source
// pointer is made once a chunk, behind an empty asm, and stepped by
// STEP rows a piece.  Without the asm the bodies spilled 44-84 bytes (each
// piece's 64-bit offset kept across the chunk loop, the likeliest cause);
// with the loops rolled instead they ran 10-12% slower.
template <int BYTES, int ROWS, int COLS>
__device__ __forceinline__ void stage_tile(float* dst, int ld,
                                           const float* src, int stride,
                                           int valid, int cvalid) {
  constexpr int PER = BYTES / 4, PIECES = COLS / PER;
  constexpr int STEP = kPThreads / PIECES;    // rows a pass
  static_assert(kPThreads % PIECES == 0 && ROWS % STEP == 0, "pieces");
  const int r = threadIdx.x / PIECES, c = threadIdx.x % PIECES * PER;
  const float* s = src + static_cast<long long>(r) * stride + c;
  asm volatile("" : "+l"(s));
  const long long step = static_cast<long long>(STEP) * stride;
  float* p = dst + r * ld + c;
  #pragma unroll
  for (int i = 0; i < ROWS / STEP; ++i, s += step, p += STEP * ld) {
    const bool ok = r + STEP * i < valid && c < cvalid;
    if constexpr (BYTES == 16) {
      cp_async16(p, ok ? s : src, ok ? 16 : 0);
    } else if constexpr (BYTES == 8) {
      cp_async8(p, ok ? s : src, ok ? 8 : 0);
    } else {
      cp_async4(p, ok ? s : src, ok ? 4 : 0);
    }
  }
}

// the same tile of a bf16 source, element by element: thread t takes
// column t % COLS of rows t / COLS, + STEP, ... (consecutive threads,
// consecutive columns), loads kPer of its elements before it widens and
// stores any, so they are in flight together; its source pointer is made
// once, behind an empty asm, and stepped by STEP rows (stage_tile's
// cure for spills)
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_wide(float* dst, int ld,
                                           const uint16_t* src, int stride,
                                           int valid, int cvalid) {
  constexpr int kPer = 8, STEP = kPThreads / COLS, N = ROWS / STEP;
  static_assert(kPThreads % COLS == 0 && ROWS % STEP == 0 && N % kPer == 0,
                "elements");
  const int r = threadIdx.x / COLS, c = threadIdx.x % COLS;
  const uint16_t* s = src + static_cast<long long>(r) * stride + c;
  asm volatile("" : "+l"(s));
  const long long step = static_cast<long long>(STEP) * stride;
  float* p = dst + r * ld + c;
  #pragma unroll
  for (int i0 = 0; i0 < N; i0 += kPer) {
    uint16_t v[kPer];
    #pragma unroll
    for (int u = 0; u < kPer; ++u, s += step) {
      v[u] = r + STEP * (i0 + u) < valid && c < cvalid
                 ? __ldg(s) : static_cast<uint16_t>(0);
    }
    #pragma unroll
    for (int u = 0; u < kPer; ++u, p += STEP * ld) *p = widen(v[u]);
  }
}

// a tile of feat or W: BYTES = 16, 8 or 4, fp32 rows in cp.async pieces
// of that size; 2, a bf16 source widened element by element
template <int BYTES, int ROWS, int COLS, typename T>
__device__ __forceinline__ void stage_any(float* dst, int ld, const T* src,
                                          int stride, int valid,
                                          int cvalid) {
  if constexpr (BYTES == 2) {
    stage_wide<ROWS, COLS>(dst, ld, src, stride, valid, cvalid);
  } else {
    stage_tile<BYTES, ROWS, COLS>(dst, ld, src, stride, valid, cvalid);
  }
}

// acc += the feat tile's rows [32 wm, +32) . W tile's columns [32 wn, +32)
// over one chunk: 3xTF32 mma.m16n8k8, k-index t of a step column 2t and
// t + 4 column 2t + 1 (feat: one 8-byte load a pair; W: rows 2t, 2t + 1),
// hi and lo split as loaded, the small products first
__device__ __forceinline__ void p_products(float (&acc)[kPMI][kPNI][4],
                                           const float* as, const float* bs,
                                           int wm, int wn) {
  constexpr int MI = kPMI, NI = kPNI;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float* qa = as + (16 * MI * wm + g) * kPLdA + 2 * t4;
  const float* wb = bs + 2 * t4 * kPLdB + 8 * NI * wn + g;
  #pragma unroll
  for (int kk = 0; kk < kPDc / 8; ++kk) {
    uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
    #pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const float* r = qa + 16 * mi * kPLdA + kk * 8;
      const float2 x0 = *reinterpret_cast<const float2*>(r);
      const float2 x1 = *reinterpret_cast<const float2*>(r + 8 * kPLdA);
      split_tf32(x0.x, ah[mi][0], al[mi][0]);
      split_tf32(x1.x, ah[mi][1], al[mi][1]);
      split_tf32(x0.y, ah[mi][2], al[mi][2]);
      split_tf32(x1.y, ah[mi][3], al[mi][3]);
    }
    #pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const float* p = wb + kk * 8 * kPLdB + 8 * ni;
      split_tf32(p[0], bh[ni][0], bl[ni][0]);
      split_tf32(p[kPLdB], bh[ni][1], bl[ni][1]);
    }
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

// One CTA per 64 rows of feat x 128 columns of W (blockIdx.y), two CTAs
// an SM.  AB / WB: the cp.async piece of feat's / W's fp32 rows, in
// bytes, or AB = 2 for a bf16 feat.  y is float32, or bf16 for out_bf16.
// nrows: where given, the rows on the card (at most Nf); a CTA then takes
// row tiles blockIdx.x, + gridDim.x, ... (the grid sized for the bound
// would be mostly CTAs with no row).
template <int AB, int WB>
__global__ void __launch_bounds__(kPThreads, 2)
project_kernel(const void* __restrict__ feat_, const void* __restrict__ w_,
               void* __restrict__ y, const int* __restrict__ nrows, int Nf,
               int d, int f, int out_bf16) {
  using TA = typename std::conditional<AB == 2, uint16_t, float>::type;
  if (nrows != nullptr) Nf = *nrows;
  const TA* feat = static_cast<const TA*>(feat_);
  const float* w = static_cast<const float*>(w_);
  constexpr int MI = kPMI, NI = kPNI;
  extern __shared__ __align__(16) float p_smem[];   // [stage][feat | W]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp / kPWN, wn = warp % kPWN;
  for (long long tile = blockIdx.x; tile * kPRows < Nf; tile += gridDim.x) {
    const long long r0 = tile * kPRows;
    const int f0 = blockIdx.y * kPCols;
    const int rv = static_cast<int>(Nf - r0 < kPRows ? Nf - r0 : kPRows);
    const int fv = f - f0;
    const TA* fa = feat + r0 * d;
    const float* wa = w + f0;
    const int n_chunks = (d + kPDc - 1) / kPDc;
    auto stage = [&](int c) {
      float* st = p_smem + (c % kPStages) * kPStage;
      const int d0 = c * kPDc;
      stage_any<AB, kPRows, kPDc>(st, kPLdA, fa + d0, d, rv, d - d0);
      stage_any<WB, kPDc, kPCols>(st + kPRows * kPLdA, kPLdB,
                                  wa + (long long)d0 * f, f, d - d0, fv);
    };

    float acc[MI][NI][4];
    #pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      #pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        #pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    #pragma unroll
    for (int c = 0; c < kPStages - 1; ++c) {
      if (c < n_chunks) stage(c);
      cp_async_commit();
    }
    for (int ch = 0; ch < n_chunks; ++ch) {
      cp_async_wait<kPStages - 2>();
      __syncthreads();   // chunk ch is in; every read of the slot refilled
      if (ch + kPStages - 1 < n_chunks) stage(ch + kPStages - 1);
      cp_async_commit();
      const float* as = p_smem + (ch % kPStages) * kPStage;
      // a fresh accumulator a chunk, added to acc rounded to nearest: the
      // tensor cores' adder truncates, and its bias would grow with d
      float part[MI][NI][4] = {};
      p_products(part, as, as + kPRows * kPLdA, wm, wn);
      #pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        #pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          #pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
    }
    cp_async_wait<0>();

    const bool pairs = (f & 1) == 0;
    #pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = 16 * (MI * wm + mi) + g + 8 * h;
        if (lr >= rv) continue;
        const long long y0 = (r0 + lr) * f + f0;
        float* yrow = static_cast<float*>(y) + y0;
        uint16_t* hrow = static_cast<uint16_t*>(y) + y0;
        #pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int lc = 8 * (NI * wn + ni) + 2 * t4;
          if (lc >= fv) continue;
          const float a = acc[mi][ni][2 * h], b = acc[mi][ni][2 * h + 1];
          if (out_bf16) {
            if (pairs) {
              *reinterpret_cast<uint32_t*>(hrow + lc) =
                  to_bf16(a) | static_cast<uint32_t>(to_bf16(b)) << 16;
            } else {
              hrow[lc] = to_bf16(a);
              if (lc + 1 < fv) hrow[lc + 1] = to_bf16(b);
            }
          } else if (pairs) {
            *reinterpret_cast<float2*>(yrow + lc) = make_float2(a, b);
          } else {
            yrow[lc] = a;
            if (lc + 1 < fv) yrow[lc + 1] = b;
          }
        }
      }
    __syncthreads();   // the ring is free for the next tile
  }
}

// ---- "transform" (b): the gather and mean over Y's rows -------------------

constexpr int kGWarps = 8;     // output rows a CTA, one a warp
constexpr int kGCols = 128;    // columns a warp: 4 a lane
// CTAs of a launch over listed rows, whose count is on the card: the
// gather and the copy (looping), the projection (two an SM, looping)
constexpr long long kRowsBlocks = 132 * 8;
constexpr long long kProjectRowsBlocks = 132 * 2;

// VEC: lane l holds columns 4l .. 4l + 3 of the tile (one float4 load a
// row); else columns l + 32 j, j < 4.  out is float32, or bf16 for
// out_bf16.  Output row k aggregates row i = rows[k] of nbrs, k < *nrows
// (where given; else i = k < N); a warp takes rows k, + the grid's warps,
// ... (one, where the grid covers N).
template <bool VEC>
__global__ void __launch_bounds__(kGWarps * 32)
gather_kernel(const int32_t* __restrict__ nbrs, const float* __restrict__ y,
              void* __restrict__ out, const int* __restrict__ rows,
              const int* __restrict__ nrows, int N, int M, int Nf, int f,
              int mean, int out_bf16) {
  const int lane = threadIdx.x & 31;
  const long long n = nrows != nullptr ? *nrows : N;
  for (long long k = (long long)blockIdx.x * kGWarps + (threadIdx.x >> 5);
       k < n; k += (long long)gridDim.x * kGWarps) {
    const long long i = rows != nullptr ? rows[k] : k;
    const int f0 = blockIdx.y * kGCols;
    const int c0 = f0 + (VEC ? 4 * lane : lane);
    bool col[4];
    #pragma unroll
    for (int j = 0; j < 4; ++j) col[j] = (VEC ? c0 : c0 + 32 * j) < f;
    const int32_t* rid = nbrs + i * M;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    int cnt = 0;
    for (int t0 = 0; t0 < M; t0 += 32) {
      // the lane's id: the row read (a negative id reads row 0), -1 skipped
      int32_t id = -1;
      if (t0 + lane < M) {
        const int32_t raw = __ldg(rid + t0 + lane);
        if (raw < Nf) id = raw < 0 ? 0 : raw;
      }
      cnt += __popc(__ballot_sync(0xffffffffu, id >= 0));
      const int m = M - t0 < 32 ? M - t0 : 32;
      for (int u0 = 0; u0 < m; u0 += kBatch) {
        float v[kBatch][4];
        #pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int32_t src = __shfl_sync(0xffffffffu, id, u0 + u);
          #pragma unroll
          for (int j = 0; j < 4; ++j) v[u][j] = 0.f;
          if (u0 + u >= m || src < 0) continue;
          const float* row = y + (long long)src * f;
          if constexpr (VEC) {
            if (col[0]) {
              const float4 x =
                  __ldg(reinterpret_cast<const float4*>(row + c0));
              v[u][0] = x.x;
              v[u][1] = x.y;
              v[u][2] = x.z;
              v[u][3] = x.w;
            }
          } else {
            #pragma unroll
            for (int j = 0; j < 4; ++j)
              if (col[j]) v[u][j] = __ldg(row + c0 + 32 * j);
          }
        }
        #pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u0 + u < m) {
            #pragma unroll
            for (int j = 0; j < 4; ++j) s[j] += v[u][j];
          }
        }
      }
    }
    if (mean) {
      const float div = static_cast<float>(cnt > 1 ? cnt : 1);
      #pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = __fdiv_rn(s[j], div);
    }
    if (out_bf16) {
      uint16_t* hrow = static_cast<uint16_t*>(out) + k * f;
      if constexpr (VEC) {
        if (col[0])
          *reinterpret_cast<uint2*>(hrow + c0) = make_uint2(
              to_bf16(s[0]) | static_cast<uint32_t>(to_bf16(s[1])) << 16,
              to_bf16(s[2]) | static_cast<uint32_t>(to_bf16(s[3])) << 16);
      } else {
        #pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col[j]) hrow[c0 + 32 * j] = to_bf16(s[j]);
      }
      continue;
    }
    float* orow = static_cast<float*>(out) + k * f;
    if constexpr (VEC) {
      if (col[0])
        *reinterpret_cast<float4*>(orow + c0) = make_float4(s[0], s[1], s[2],
                                                            s[3]);
    } else {
      #pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col[j]) orow[c0 + 32 * j] = s[j];
    }
  }
}

// dst[k] = src[rows[k]] for k < *nrows, rows of C floats: a warp a row,
// a float4 a lane (VEC: C % 4 == 0, both 16-byte aligned) or a float
template <bool VEC>
__global__ void __launch_bounds__(kGWarps * 32)
copy_rows_kernel(const float* __restrict__ src, const int* __restrict__ rows,
                 const int* __restrict__ nrows, float* __restrict__ dst,
                 int C) {
  const int lane = threadIdx.x & 31;
  const long long n = *nrows;
  const long long warps = static_cast<long long>(gridDim.x) * kGWarps;
  for (long long k = (long long)blockIdx.x * kGWarps + (threadIdx.x >> 5);
       k < n; k += warps) {
    const float* s = src + static_cast<long long>(rows[k]) * C;
    float* t = dst + k * C;
    if constexpr (VEC) {
      for (int c = lane; c < C / 4; c += 32)
        reinterpret_cast<float4*>(t)[c] =
            __ldg(reinterpret_cast<const float4*>(s) + c);
    } else {
      for (int c = lane; c < C; c += 32) t[c] = __ldg(s + c);
    }
  }
}

// the fused body for feat's type TF, its [64, M] ids in dynamic shared
// memory
template <typename TF>
int launch_fused(dim3 grid, const void* nbrs, const void* feat,
                 const void* w, void* out, int N, int M, int Nf, int d, int f,
                 int mean, cudaStream_t st) {
  const size_t smem = (size_t)kRows * M * sizeof(int32_t);
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        spmm_kernel<TF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  spmm_kernel<TF><<<grid, kThreads, smem, st>>>(
      static_cast<const int32_t*>(nbrs), static_cast<const TF*>(feat),
      static_cast<const float*>(w), static_cast<TF*>(out), N, M, Nf, d, f,
      mean);
  return static_cast<int>(cudaGetLastError());
}

// the projection's bodies by the cp.async pieces of feat's rows and W's
// (bytes; 2: a bf16 feat), in kernels/segment_matmul.py BODIES' order
using ProjectFn = void (*)(const void*, const void*, void*, const int*, int,
                           int, int, int);
constexpr ProjectFn kProjectBodies[] = {
    project_kernel<16, 16>, project_kernel<8, 16>, project_kernel<4, 4>,
    project_kernel<2, 16>,  project_kernel<2, 4>};
constexpr int kNProject = sizeof(kProjectBodies) / sizeof(ProjectFn);

}  // namespace

// "fused": neighbors [N, M] int32, feat [Nf, d] float32 (feat_bf16 = 0)
// or bf16 (1), w [d, f] float32 -> out [N, f] in feat's type; mean != 0 divides each aggregate by its valid count.
extern "C" int repro_spmm_fused(const void* nbrs, const void* feat,
                                const void* w, void* out, int N, int M,
                                int Nf, int d, int f, int mean, int feat_bf16,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  const int f_tiles = (f + kCols - 1) / kCols;
  if (f_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((N + (long long)kRows - 1) / kRows),
                  f_tiles);
  return feat_bf16 ? launch_fused<uint16_t>(grid, nbrs, feat, w, out, N, M,
                                            Nf, d, f, mean, st)
                   : launch_fused<float>(grid, nbrs, feat, w, out, N, M, Nf,
                                         d, f, mean, st);
}

// the projection's launch; nrows: the rows on the card, at most Nf, or
// null for Nf
static int launch_project(const void* feat, const void* w, void* y,
                          const int* nrows, int Nf, int d, int f,
                          int feat_bf16, int out_bf16, cudaStream_t st) {
  if (Nf == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  const int f_tiles = (f + kPCols - 1) / kPCols;
  if (f_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t fp = reinterpret_cast<uintptr_t>(feat);
  const uintptr_t wp = reinterpret_cast<uintptr_t>(w);
  const bool w16 = f % 4 == 0 && wp % 16 == 0;
  int body;
  if (feat_bf16) {
    body = w16 ? 3 : 4;
  } else {
    body = w16 && d % 4 == 0 && fp % 16 == 0 ? 0
           : w16 && d % 2 == 0 && fp % 8 == 0 ? 1 : 2;
  }
  const auto kern = kProjectBodies[body];
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kPSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  long long tiles = (Nf + (long long)kPRows - 1) / kPRows;
  if (nrows != nullptr && tiles > kProjectRowsBlocks)
    tiles = kProjectRowsBlocks;
  const dim3 grid(static_cast<unsigned>(tiles), f_tiles);
  kern<<<grid, kPThreads, kPSmem, st>>>(feat, w, y, nrows, Nf, d, f,
                                        out_bf16);
  return static_cast<int>(cudaGetLastError());
}

// "transform" (a): feat [Nf, d] float32 or bf16 (feat_bf16) x w [d, f]
// float32 -> y [Nf, f] float32, or bf16 for out_bf16 (y 8-byte aligned).
extern "C" int repro_spmm_project(const void* feat, const void* w, void* y,
                                  int Nf, int d, int f, int feat_bf16,
                                  int out_bf16, void* stream) {
  return launch_project(feat, w, y, nullptr, Nf, d, f, feat_bf16, out_bf16,
                        static_cast<cudaStream_t>(stream));
}

// The projection of listed rows: a [N, d] float32's rows rows[k], k <
// *nrows (at most N, counted on the card), copied into a_rows [N, d] in
// that order, then y [N, f] float32 = a_rows @ w (rows past *nrows
// untouched).  Two launches.
extern "C" int repro_spmm_project_rows(const void* a, const void* w, void* y,
                                       void* a_rows, const void* rows,
                                       const void* nrows, int N, int d,
                                       int f, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  if (d > 0) {
    const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(a_rows) % 16 == 0;
    const long long b = (N + (long long)kGWarps - 1) / kGWarps;
    const unsigned blocks =
        static_cast<unsigned>(b < kRowsBlocks ? b : kRowsBlocks);
    auto kern = vec ? copy_rows_kernel<true> : copy_rows_kernel<false>;
    kern<<<blocks, kGWarps * 32, 0, st>>>(
        static_cast<const float*>(a), static_cast<const int*>(rows),
        static_cast<const int*>(nrows), static_cast<float*>(a_rows), d);
  }
  return launch_project(a_rows, w, y, static_cast<const int*>(nrows),
                        N, d, f, 0, 0, st);
}

// "transform" (b): neighbors [N, M] int32 over y [Nf, f] float32 -> out
// [N, f] float32, or bf16 for out_bf16, the lane-order sum (mean != 0:
// divided by the count).
extern "C" int repro_spmm_gather(const void* nbrs, const void* y, void* out,
                                 int N, int M, int Nf, int f, int mean,
                                 int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  const int f_tiles = (f + kGCols - 1) / kGCols;
  if (f_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((N + (long long)kGWarps - 1) /
                                        kGWarps), f_tiles);
  auto kern = vec ? gather_kernel<true> : gather_kernel<false>;
  kern<<<grid, kGWarps * 32, 0, st>>>(
      static_cast<const int32_t*>(nbrs), static_cast<const float*>(y), out,
      nullptr, nullptr, N, M, Nf, f, mean, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

// The gather of listed rows: out [N, f] float32, row k the lane-order sum
// (mean != 0: divided by the count) of row rows[k] of neighbors [N, M]
// over y [Nf, f] float32, k < *nrows (at most N, counted on the card).
extern "C" int repro_spmm_gather_rows(const void* nbrs, const void* y,
                                      void* out, const void* rows,
                                      const void* nrows, int N, int M, int Nf,
                                      int f, int mean, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  const int f_tiles = (f + kGCols - 1) / kGCols;
  if (f_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  // the grid sized for at most kRowsBlocks CTAs a column tile, looping
  const long long b = (N + (long long)kGWarps - 1) / kGWarps;
  const dim3 grid(static_cast<unsigned>(b < kRowsBlocks ? b : kRowsBlocks),
                  f_tiles);
  auto kern = vec ? gather_kernel<true> : gather_kernel<false>;
  kern<<<grid, kGWarps * 32, 0, st>>>(
      static_cast<const int32_t*>(nbrs), static_cast<const float*>(y), out,
      static_cast<const int*>(rows), static_cast<const int*>(nrows), N, M,
      Nf, f, mean, 0);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local (spilled) bytes a thread of body `which`, in the
// order of kernels/segment_matmul.py BODIES: fused fp32, fused bf16, the
// five projections (kProjectBodies), gather with float4 rows, gather
// element-wise, the copy of listed rows in float4 and element-wise.
extern "C" int repro_spmm_attrs(int which, int* regs, int* local_bytes) {
  constexpr int n = 2 + kNProject + 4;
  if (which < 0 || which >= n) return static_cast<int>(cudaErrorInvalidValue);
  const int k = which - 2 - kNProject;
  const void* body =
      which == 0   ? reinterpret_cast<const void*>(spmm_kernel<float>)
      : which == 1 ? reinterpret_cast<const void*>(spmm_kernel<uint16_t>)
      : k < 0      ? reinterpret_cast<const void*>(kProjectBodies[which - 2])
      : k == 0     ? reinterpret_cast<const void*>(gather_kernel<true>)
      : k == 1     ? reinterpret_cast<const void*>(gather_kernel<false>)
      : k == 2     ? reinterpret_cast<const void*>(copy_rows_kernel<true>)
                   : reinterpret_cast<const void*>(copy_rows_kernel<false>);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, body);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
