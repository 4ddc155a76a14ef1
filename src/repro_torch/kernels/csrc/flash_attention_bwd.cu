// The gradient of flash_attention (causal, sliding-window, grouped-query
// attention) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference trains through the plain
// chunked_attention (src/repro/models/layers.py:86) and takes its
// gradient by autodiff; its Pallas kernel has no backward.  The port
// trains through its forward kernel (flash_attention.cu, which this file
// does not touch), so the gradient needs a kernel of its own: given q
// [B, Sq, H, hd], k and v [B, Skv, KV, hd] (H = KV * G, head h reads KV
// head h / G) and dout [B, Sq, H, hd], all float32 or all bfloat16, it
// writes dq, dk and dv in the same type and layout.  With s_ij = scale *
// <q_i, k_j> over the visible keys (j <= q_offset + i and, for
// window > 0, j > q_offset + i - window), P = softmax(s) and
// O = P V:
//
//   D_i  = sum_d dout_id O_id,    dP_ij = <dout_i, v_j>,
//   dS_ij = P_ij (dP_ij - D_i),
//   dq_i = scale sum_j dS_ij k_j,  dk_j = scale sum_i dS_ij q_i,
//   dv_j = sum_i P_ij dout_i      (dk and dv summed over the G heads).
//
// Arithmetic.  Every product and sum is float32 on the CUDA cores (FFMA);
// bf16 inputs are widened as they are staged, and the outputs are rounded
// once.  O is recomputed in float32 (the forward's online softmax) rather
// than read back from the forward's output: a bf16 O would put its
// rounding, 2^-9 of each element, into D and from there into every dS of
// the row, where a bf16 output's own rounding allows it nothing.
//
// Bounds on the H100.  At OLMo-1B's layer, [4, 2048, 16 x 128] causal,
// 134.3 M (query, key) pairs a head summed over the heads, the gradient
// needs 10 hd operations a pair (S, dP, dv, dk, dq): 171.9 GFLOP, 0.174 ms
// at the 989 TFLOP/s of bf16 tensor cores, 2.57 ms at the 67 TFLOP/s of
// float32 FFMA.  This design does 18 hd a pair (S twice and O in the
// first pass, S again in the second), so its own floor is 4.6 ms at the
// FFMA rate: a simple kernel, right first; tensor cores are later work.
//
// Design: two passes, no atomics, so a repeat is bit for bit.
//   (i)  dq_kernel: one CTA per (64 query rows, q head, batch row).  Q
//        and dout stay in shared memory; the visible key tiles stream
//        through twice.  The first loop keeps the online softmax (row max,
//        sum) and O in registers, then writes the log-sum-exp and D; the
//        second recomputes P = exp(s - lse), dP and dS and sums dq.
//   (ii) dkv_kernel: one CTA per (64 keys, KV head, batch row).  K and V
//        stay in shared memory; the kernel loops over the group's G heads
//        and over the query tiles that see the key tile, recomputes P and
//        dS from (i)'s lse and D, and sums dk and dv in registers.
// Each thread owns a few rows of a tile (the same rows in the scores and
// in its accumulators, so the softmax statistics stay in its registers)
// and every TX-th column.  Rows in shared memory are padded to an odd
// stride, so the column walks and the row walks both avoid bank
// conflicts.  The head width is padded with zeros to 32, 64, 128 or 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // query rows of a dq CTA, keys of a dkv CTA

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD>
struct Cfg {
  static constexpr int TX = HD <= 128 ? 16 : 8;   // threads across columns
  static constexpr int TY = kThreads / TX;        // threads across rows
  static constexpr int COLS = 4 * TX;   // the other side's tile: keys (i),
                                        // queries (ii)
  static constexpr int RPT = kRows / TY;          // rows a thread
  static constexpr int DPT = HD / TX;             // head columns a thread
  static constexpr int LD = HD + 1;               // odd row strides
  static constexpr int LDC = COLS + 1;
  static constexpr size_t kDqSmem =
      sizeof(float) * (2 * kRows * LD + 2 * COLS * LD + kRows * LDC);
  static constexpr size_t kDkvSmem =
      sizeof(float) * (2 * kRows * LD + 2 * COLS * LD + 2 * kRows * LDC +
                       2 * COLS);
};

// rows [0, R) of a block with row stride `stride` (elements) into a
// [R][HD + 1] float tile: rows past `valid` and columns past hd are zeros
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int R, int valid,
                                      int hd) {
  for (int e = threadIdx.x; e < R * HD; e += kThreads) {
    const int r = e / HD, c = e - r * HD;
    float x = 0.f;
    if (r < valid && c < hd) x = widen(src[r * stride + c]);
    dst[r * (HD + 1) + c] = x;
  }
}

__device__ __forceinline__ bool sees(int pos, int j, int window) {
  return j <= pos && (window <= 0 || j > pos - window);
}

// acc[i][jj] = <a row ty + TY i, b row tx + TX jj> over the head
template <int HD>
__device__ __forceinline__ void dots(const float* a, const float* b, int ty,
                                     int tx,
                                     float (&acc)[Cfg<HD>::RPT][4]) {
  using C = Cfg<HD>;
#pragma unroll
  for (int i = 0; i < C::RPT; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
  const float* ar = a + ty * C::LD;
  const float* br = b + tx * C::LD;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float x[C::RPT], y[4];
#pragma unroll
    for (int i = 0; i < C::RPT; ++i) x[i] = ar[i * C::TY * C::LD + d];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) y[jj] = br[jj * C::TX * C::LD + d];
#pragma unroll
    for (int i = 0; i < C::RPT; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(x[i], y[jj], acc[i][jj]);
  }
}

// acc[i][dd] += sum_c w[row ty + TY i][c] m[c][tx + TX dd]
template <int HD>
__device__ __forceinline__ void accumulate(const float* w, const float* m,
                                           int ty, int tx,
                                           float (&acc)[Cfg<HD>::RPT]
                                                       [Cfg<HD>::DPT]) {
  using C = Cfg<HD>;
  const float* wr = w + ty * C::LDC;
  const float* mr = m + tx;
#pragma unroll 2
  for (int c = 0; c < C::COLS; ++c) {
    float x[C::RPT];
#pragma unroll
    for (int i = 0; i < C::RPT; ++i) x[i] = wr[i * C::TY * C::LDC + c];
#pragma unroll
    for (int dd = 0; dd < C::DPT; ++dd) {
      const float y = mr[c * C::LD + dd * C::TX];
#pragma unroll
      for (int i = 0; i < C::RPT; ++i) acc[i][dd] = fmaf(x[i], y, acc[i][dd]);
    }
  }
}

// the sum (or max) over the TX lanes that share a row
template <int TX>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
template <int TX>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// (i): dq, and each row's log-sum-exp and D for (ii).  lse and delta are
// [B, H, Sq] float32.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          T* __restrict__ dq, float* __restrict__ lse_out,
          float* __restrict__ delta_out, int Sq, int Skv, int H, int KV,
          int hd, int window, int q_offset, float scale) {
  using C = Cfg<HD>;
  constexpr int RPT = C::RPT, DPT = C::DPT, TX = C::TX, TY = C::TY;
  constexpr int COLS = C::COLS, LD = C::LD, LDC = C::LDC;
  extern __shared__ float smem[];
  float* sQ = smem;                  // [kRows][LD]
  float* sdO = sQ + kRows * LD;      // [kRows][LD]
  float* sK = sdO + kRows * LD;      // [COLS][LD]
  float* sV = sK + COLS * LD;        // [COLS][LD]
  float* sP = sV + COLS * LD;        // [kRows][LDC]: P, then dS

  const int i0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // long rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const long long q_row = (long long)H * hd, kv_row = (long long)KV * hd;
  const long long q_at = ((long long)b * Sq + i0) * q_row + (long long)h * hd;
  const T* kb = k + (long long)b * Skv * kv_row + (long long)kvh * hd;
  const T* vb = v + (long long)b * Skv * kv_row + (long long)kvh * hd;
  const int rows = min(kRows, Sq - i0);
  stage<T, HD>(sQ, q + q_at, q_row, kRows, rows, hd);
  stage<T, HD>(sdO, dout + q_at, q_row, kRows, rows, hd);

  // the keys some row of the tile sees: [lo, hi)
  const int hi = min(Skv, q_offset + i0 + rows);
  const int lo = window > 0 ? max(0, q_offset + i0 - window + 1) : 0;
  int pos[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) pos[i] = q_offset + i0 + ty + TY * i;

  float m[RPT], l[RPT], o[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) o[i][dd] = 0.f;
  }
  // first loop: the online softmax and O = P V in float32
  for (int j0 = lo / COLS * COLS; j0 < hi; j0 += COLS) {
    __syncthreads();
    stage<T, HD>(sK, kb + j0 * kv_row, kv_row, COLS, Skv - j0, hd);
    stage<T, HD>(sV, vb + j0 * kv_row, kv_row, COLS, Skv - j0, hd);
    __syncthreads();
    float s[RPT][4];
    dots<HD>(sQ, sK, ty, tx, s);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + tx + TX * jj;
        s[i][jj] = (j < Skv && sees(pos[i], j, window)) ? s[i][jj] * scale
                                                        : -INFINITY;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max<TX>(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_use);
        sum += p;
        sP[(ty + TY * i) * LDC + tx + TX * jj] = p;
      }
      l[i] = l[i] * corr + row_sum<TX>(sum);
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) o[i][dd] *= corr;
    }
    __syncthreads();
    accumulate<HD>(sP, sV, ty, tx, o);
  }
  // lse and D = rowsum(dout o O)
  float lse[RPT], dlt[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    const float* dor = sdO + (ty + TY * i) * LD + tx;
    float part = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) part += o[i][dd] * inv * dor[dd * TX];
    dlt[i] = row_sum<TX>(part);
    lse[i] = m[i] + logf(l[i]);
    const int r = ty + TY * i;
    if (tx == 0 && r < rows) {
      const long long at = ((long long)b * H + h) * Sq + i0 + r;
      lse_out[at] = lse[i];
      delta_out[at] = dlt[i];
    }
  }
  // second loop: dS and dq
  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = 0.f;
  for (int j0 = lo / COLS * COLS; j0 < hi; j0 += COLS) {
    __syncthreads();
    stage<T, HD>(sK, kb + j0 * kv_row, kv_row, COLS, Skv - j0, hd);
    stage<T, HD>(sV, vb + j0 * kv_row, kv_row, COLS, Skv - j0, hd);
    __syncthreads();
    float s[RPT][4], dp[RPT][4];
    dots<HD>(sQ, sK, ty, tx, s);
    dots<HD>(sdO, sV, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + tx + TX * jj;
        float ds = 0.f;
        if (j < Skv && sees(pos[i], j, window))
          ds = expf(s[i][jj] * scale - lse[i]) * (dp[i][jj] - dlt[i]);
        sP[(ty + TY * i) * LDC + tx + TX * jj] = ds;
      }
    __syncthreads();
    accumulate<HD>(sP, sK, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + TY * i;
    if (r >= rows) continue;
    T* out = dq + q_at + r * q_row;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      const int c = tx + TX * dd;
      if (c < hd) store(out + c, acc[i][dd] * scale);
    }
  }
}

// (ii): dk and dv of 64 keys of one KV head, over its G heads
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H,
           int KV, int hd, int window, int q_offset, float scale) {
  using C = Cfg<HD>;
  constexpr int RPT = C::RPT, DPT = C::DPT, TX = C::TX, TY = C::TY;
  constexpr int COLS = C::COLS, LD = C::LD, LDC = C::LDC;
  extern __shared__ float smem[];
  float* sK = smem;                  // [kRows][LD]
  float* sV = sK + kRows * LD;       // [kRows][LD]
  float* sQ = sV + kRows * LD;       // [COLS][LD]
  float* sdO = sQ + COLS * LD;       // [COLS][LD]
  float* sP = sdO + COLS * LD;       // [kRows][LDC], keys x queries
  float* sS = sP + kRows * LDC;      // [kRows][LDC]: dS
  float* sL = sS + kRows * LDC;      // [COLS]
  float* sD = sL + COLS;             // [COLS]

  const int j0 = blockIdx.x * kRows, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const long long q_row = (long long)H * hd, kv_row = (long long)KV * hd;
  const long long kv_at =
      ((long long)b * Skv + j0) * kv_row + (long long)kvh * hd;
  const int keys = min(kRows, Skv - j0);
  stage<T, HD>(sK, k + kv_at, kv_row, kRows, keys, hd);
  stage<T, HD>(sV, v + kv_at, kv_row, kRows, keys, hd);

  // the query rows that see some key of the tile: [lo, hi)
  const int lo = max(0, j0 - q_offset);
  const int hi = window > 0 ? min(Sq, j0 + keys - 1 + window - q_offset)
                            : Sq;
  float ka[RPT][DPT], va[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) ka[i][dd] = va[i][dd] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long row_at = ((long long)b * H + h) * Sq;
    for (int i0 = lo / COLS * COLS; i0 < hi; i0 += COLS) {
      __syncthreads();
      const long long q_at =
          ((long long)b * Sq + i0) * q_row + (long long)h * hd;
      stage<T, HD>(sQ, q + q_at, q_row, COLS, Sq - i0, hd);
      stage<T, HD>(sdO, dout + q_at, q_row, COLS, Sq - i0, hd);
      for (int c = threadIdx.x; c < COLS; c += kThreads) {
        const bool ok = i0 + c < Sq;
        sL[c] = ok ? lse[row_at + i0 + c] : 0.f;
        sD[c] = ok ? delta[row_at + i0 + c] : 0.f;
      }
      __syncthreads();
      float s[RPT][4], dp[RPT][4];
      dots<HD>(sK, sQ, ty, tx, s);
      dots<HD>(sV, sdO, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j0 + ty + TY * i, c = tx + TX * jj, qi = i0 + c;
          float p = 0.f, ds = 0.f;
          if (qi < Sq && j < Skv && sees(q_offset + qi, j, window)) {
            p = expf(s[i][jj] * scale - sL[c]);
            ds = p * (dp[i][jj] - sD[c]);
          }
          sP[(ty + TY * i) * LDC + c] = p;
          sS[(ty + TY * i) * LDC + c] = ds;
        }
      __syncthreads();
      accumulate<HD>(sP, sdO, ty, tx, va);
      accumulate<HD>(sS, sQ, ty, tx, ka);
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + TY * i;
    if (r >= keys) continue;
    T* ko = dk + kv_at + r * kv_row;
    T* vo = dv + kv_at + r * kv_row;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      const int c = tx + TX * dd;
      if (c < hd) {
        store(ko + c, ka[i][dd] * scale);
        store(vo + c, va[i][dd]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  int B, Sq, Skv, H, KV, hd, window, q_offset;
  float scale;
};

template <typename T, int HD>
int launch_dq(const Args& a, void* dq, float* lse, float* delta,
              cudaStream_t st) {
  constexpr size_t smem = Cfg<HD>::kDqSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kRows - 1) / kRows, a.H, a.B);
  dq_kernel<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<T*>(dq), lse, delta, a.Sq, a.Skv, a.H, a.KV, a.hd,
      a.window, a.q_offset, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkv(const Args& a, const float* lse, const float* delta,
               void* dk, void* dv, cudaStream_t st) {
  constexpr size_t smem = Cfg<HD>::kDkvSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Skv + kRows - 1) / kRows, a.KV, a.B);
  dkv_kernel<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), a.Sq, a.Skv, a.H, a.KV,
      a.hd, a.window, a.q_offset, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dq(const Args& a, void* dq, float* lse, float* delta,
                cudaStream_t st) {
  if (a.hd <= 32) return launch_dq<T, 32>(a, dq, lse, delta, st);
  if (a.hd <= 64) return launch_dq<T, 64>(a, dq, lse, delta, st);
  if (a.hd <= 128) return launch_dq<T, 128>(a, dq, lse, delta, st);
  return launch_dq<T, 256>(a, dq, lse, delta, st);
}

template <typename T>
int dispatch_dkv(const Args& a, const float* lse, const float* delta,
                 void* dk, void* dv, cudaStream_t st) {
  if (a.hd <= 32) return launch_dkv<T, 32>(a, lse, delta, dk, dv, st);
  if (a.hd <= 64) return launch_dkv<T, 64>(a, lse, delta, dk, dv, st);
  if (a.hd <= 128) return launch_dkv<T, 128>(a, lse, delta, dk, dv, st);
  return launch_dkv<T, 256>(a, lse, delta, dk, dv, st);
}

bool bad_shape(int B, int Sq, int Skv, int H, int KV, int hd) {
  return hd <= 0 || hd > 256 || KV <= 0 || H % KV != 0 || B > 65535 ||
         H > 65535 || Sq <= 0 || Skv <= 0;
}

#define REPRO_BWD_BODIES(K, T)                                       \
  reinterpret_cast<const void*>(K<T, 32>),                          \
      reinterpret_cast<const void*>(K<T, 64>),                      \
      reinterpret_cast<const void*>(K<T, 128>),                     \
      reinterpret_cast<const void*>(K<T, 256>)

}  // namespace

// (i): q, dout [B, Sq, H, hd], k and v [B, Skv, KV, hd], all float32
// (bf16 == 0) or all bfloat16 (bf16 == 1), contiguous -> dq [B, Sq, H, hd]
// in the same type, lse and delta [B, H, Sq] float32 (for (ii)).  hd <=
// 256, H a multiple of KV, B and H at most 65,535; every query row sees a
// key.
extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, void* dq, void* lse,
                                  void* delta, int B, int Sq, int Skv, int H,
                                  int KV, int hd, int window, int q_offset,
                                  float scale, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if (bad_shape(B, Sq, Skv, H, KV, hd))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, B, Sq, Skv, H, KV, hd, window, q_offset, scale};
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(delta);
  if (bf16) return dispatch_dq<__nv_bfloat16>(a, dq, l, d, st);
  return dispatch_dq<float>(a, dq, l, d, st);
}

// (ii), after (i) on the same stream: dk and dv [B, Skv, KV, hd] in the
// inputs' type, from (i)'s lse and delta.
extern "C" int repro_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int Sq, int Skv,
                                   int H, int KV, int hd, int window,
                                   int q_offset, float scale, int bf16,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if (bad_shape(B, Sq, Skv, H, KV, hd))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, B, Sq, Skv, H, KV, hd, window, q_offset, scale};
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  if (bf16) return dispatch_dkv<__nv_bfloat16>(a, l, d, dk, dv, st);
  return dispatch_dkv<float>(a, l, d, dk, dv, st);
}

// Registers and local (spilled) bytes a thread of body `which`, in the
// order of kernels/flash_attention.py BWD_BODIES: dq (bf16, then float32;
// hd 32, 64, 128, 256), then dkv in the same order.
extern "C" int repro_flash_bwd_attrs(int which, int* regs, int* local_bytes) {
  static const void* const bodies[] = {
      REPRO_BWD_BODIES(dq_kernel, __nv_bfloat16),
      REPRO_BWD_BODIES(dq_kernel, float),
      REPRO_BWD_BODIES(dkv_kernel, __nv_bfloat16),
      REPRO_BWD_BODIES(dkv_kernel, float)};
  constexpr int n = sizeof(bodies) / sizeof(bodies[0]);
  if (which < 0 || which >= n) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, bodies[which]);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
