// The gradient of flash_attention (causal, sliding-window, grouped-query
// attention) for Hopper (sm_90a), on the tensor cores.
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
// Bounds on the H100.  At OLMo-1B's layer, [4, 2048, 16 x 128] causal,
// 134.3 M visible (query, key) pairs summed over the heads, the gradient
// needs 5 products of 2 hd operations a pair (S, dP, dv, dk, dq): 171.9
// GFLOP, 0.174 ms at the 989 TFLOP/s of bf16 tensor cores.  This design
// issues 18 such products in bf16 (below): 619 GFLOP, 0.98 ms at
// mma.sync's measured ceiling of about 630 TFLOP/s.
//
// Design: two passes, no atomics, so a repeat is bit for bit.  Both run
// FA2-style tiles on mma.sync (mma_tf32.cuh), one CTA of 4 warps, each
// warp owning 16 rows of the CTA's 64; the other side's tiles stream
// through a two-stage cp.async ring (16-byte pieces; rows that are not
// 16-byte aligned take element-wise staging in the same kernel), the next
// tile loading while this one multiplies.  A warp skips a tile none of its
// rows sees, and the mask runs only on tiles some row sees in part, so a
// 1,024-token window or G = 9 costs only the visible tiles.
//   (i)  dq_kernel: one CTA per (64 query rows, q head, batch row), Q and
//        dout staged once.  The first loop is the forward's online softmax
//        (S = Q K^T, O = P V in float32) and writes each row's
//        log-sum-exp (base 2, of the scaled scores) and D; the second
//        computes S and dP = dout V^T again, P = exp2(S - lse),
//        dS = P (dP - D) in float32 registers and dq += dS K.  The two
//        loops are one stream of 2 x tiles through the ring, so the second
//        loop's first tile loads under the first loop's last.
//   (ii) dkv_kernel: one CTA per (64 keys, KV head, batch row), K and V
//        staged once; it loops over the G heads and the query tiles that
//        see its keys (Q, dout and (i)'s lse and D streamed), computes
//        S^T = K Q^T, P^T, dP^T = V dout^T and dS^T, and sums
//        dv += P^T dout and dk += dS^T Q in registers.  From hd = 128 the
//        two accumulators (hd floats a thread) leave the rest too few
//        registers, and dv and dk are two sweeps over the query tiles, S^T
//        computed in each.
// A score tile's accumulator layout is the A operand's layout, so P and
// dS stay in registers as the A operand of the next product; its B
// operand (V, K, dout or Q, [rows][hd]) is read through ldmatrix.trans.
// S and dP read their B operand (K, V, Q or dout rows) through ldmatrix;
// Q's A fragments stay in registers in (i) up to hd = 128, K's and V's
// are read from shared memory in (ii).  The tile sizes (Cfg) are the
// largest that do not spill, or the fastest where that is smaller.
//
// Arithmetic, and the split.  The contract is float32's: each element
// within twice the float32 plain version's largest error against a
// float64 oracle, plus one rounding of a bf16 output.
//   * bf16: S and dP are one bf16 product each (bf16 x bf16 is exact in
//     float32, the sums float32); q is not pre-scaled, the float32 scores
//     are scaled by scale * log2(e) for exp2.  P and dS are float32 and
//     are split into three bf16 pieces, x = hi + mid + lo, which hold a
//     float32 exactly (8 + 8 + 8 significand bits): the products with V,
//     K, dout and Q (bf16) are exact and only the order of the float32
//     sums differs from the plain version.  Two pieces (the forward's
//     split, about 2^-17 of each weight) missed the contract on dq when
//     measured, since D's and dS's rounding reach every element of a
//     row (PERF.md keeps the readings).  So (i) issues S, O (x3), S,
//     dP, dq (x3) and (ii) S, dv (x3), S, dP, dk (x3): 18 products.
//   * float32: each operand is split into three TF32 pieces (exact, as
//     split3_tf32 rounds them) and a product is six mma.m16n8k8, all
//     cross terms down to 2^-22 of |a||b|: float32's own accuracy.  The
//     forward's 3xTF32 (two pieces, three products, 2^-22 a product)
//     misses the contract at decode rows, where a gradient sums a few
//     terms and each product's error shows.  At one query row dv and dk
//     are one product each, P's float32 error is the element's, and these
//     bodies sit near twice the plain version's error (one card-test
//     shape, hd = 256 over 129 keys, missed by 0.5%).  So a float32 call
//     with at most 64 query rows a KV head takes the rows bodies below
//     (the plain version's formula computed in float64) instead.
//   * The tensor cores' adder truncates, and over 2,048 keys (18,432 over
//     G = 9) its bias would pass the contract.  So products sum into a
//     fresh accumulator that is added to the running one in float32,
//     rounded to nearest: in bf16 a tile's keys (or queries) for every 8
//     output columns, and 32 head columns of a score; in float32, where
//     no bf16 rounding of the output hides it, every 8-wide step.
//     O is recomputed in float32 rather than read back from the forward's
//     output: a bf16 O would put its rounding, 2^-9 of each element, into
//     D and from there into every dS of the row.
// The head width is padded with zeros to 32, 64, 128 or 256 (exact).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
// bf16 pieces of P and dS: three hold a float32 exactly (header note)
constexpr int kPieces = 3;
constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;   // query rows of a dq CTA, keys of dkv's
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
// (x, y) = p[NP - 1] + ... + p[0], each a pair of bf16 (x in the low half),
// the largest first: each residue is exact in float32, and with NP = 3
// the third has at most 8 significant bits, so the split is exact
template <int NP>
__device__ __forceinline__ void split_bf16(float x, float y,
                                           uint32_t (&p)[NP]) {
#pragma unroll
  for (int i = NP - 1; i >= 0; --i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 f = __bfloat1622float2(h);
    p[i] = bits(h);
    x -= f.x;
    y -= f.y;
  }
}

// 2^x to about 2 ulp (-inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x = p[0] + p[1] + p[2] (hi, mid, lo), each rounded to TF32 as cvt.rna
// rounds: exact, 11 + 11 + 11 significand bits holding float32's 24
__device__ __forceinline__ void split3_tf32(float x, uint32_t (&p)[3]) {
  p[0] = tf32_rna(x);
  const float r = x - __uint_as_float(p[0]);
  p[1] = tf32_rna(r);
  p[2] = tf32_rna(r - __uint_as_float(p[1]));
}
// the six products of a 3 x 3 split worth keeping, the smallest first:
// (lo, hi), (mid, mid), (hi, lo), (mid, hi), (hi, mid), (hi, hi); the three
// dropped are below 2^-33 of |a||b|
__device__ __forceinline__ constexpr int term_a(int t) {
  return t == 0 ? 2 : (t == 1 || t == 3) ? 1 : 0;
}
__device__ __forceinline__ constexpr int term_b(int t) {
  return t == 2 ? 2 : (t == 1 || t == 4) ? 1 : 0;
}

template <typename T, int HD>
struct Cfg {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int VEC = 16 / sizeof(T);   // elements of 16 bytes
  static constexpr int CPR = HD / VEC;         // 16-byte chunks a row
  // row stride in elements: bf16 rows 16 bytes apart modulo 128 (ldmatrix
  // both ways); float32 8 words apart modulo 32 (a thread's two
  // neighbours of a row in one 8-byte load)
  static constexpr int LD = HD + 8;
  static constexpr int NT = HD / 8;            // 8-column tiles of a row
  // (i): keys a tile; (ii): queries a tile (each the largest that does
  // not spill, or the fastest where that is smaller)
  static constexpr int BK =
      kBf16 ? (HD <= 128 ? 64 : 32) : (HD <= 64 ? 32 : 16);
  static constexpr int BQ =
      HD <= 32 ? (kBf16 ? 64 : 32) : (kBf16 && HD <= 128 ? 32 : 16);
  // Q's A fragments held in registers in (i)
  static constexpr bool kQRegs = kBf16 && HD <= 128;
  // (ii) sums dv over the query tiles, then dk in a second sweep (S^T
  // once more), where the two accumulators, HD floats a thread, leave the
  // rest too few registers
  static constexpr bool kTwoSweeps = HD >= 128;
  // k-steps (16 head columns bf16, 8 float32) a fresh score accumulator
  static constexpr int SF = kBf16 ? 2 : 1;
  // (i): Q, dout, two stages of K and of V; (ii): K, V, two stages of Q
  // and of dout, two of (lse, D)
  static constexpr size_t kDqSmem =
      sizeof(T) * static_cast<size_t>((2 * kRows + 4 * BK) * LD);
  static constexpr size_t kDkvSmem =
      sizeof(T) * static_cast<size_t>((2 * kRows + 4 * BQ) * LD) +
      sizeof(float) * 4 * BQ;
};

// rows [0, R) of a [rows][hd] block with row stride `stride` into a padded
// [R][LD] tile; rows past valid_rows and columns past hd are zeros.  With
// vec, each thread copies 16-byte chunks of one column, kThreads / CPR
// rows apart, by cp.async; else the elements one at a time.
template <typename T, int HD, int R>
__device__ __forceinline__ void stage(T* dst, const T* src, long long stride,
                                      int valid_rows, int hd, bool vec) {
  using C = Cfg<T, HD>;
  constexpr int LD = C::LD;
  if (vec) {
    constexpr int STEP = kThreads / C::CPR;
    static_assert(kThreads % C::CPR == 0, "a thread keeps its column");
    const int c = threadIdx.x % C::CPR, r0 = threadIdx.x / C::CPR;
    const bool col_ok = c * C::VEC < hd;
    const T* sp = src + r0 * stride + c * C::VEC;
    T* dp = dst + r0 * LD + c * C::VEC;
#pragma unroll
    for (int i = 0; i < (R + STEP - 1) / STEP; ++i) {
      if (R % STEP != 0 && r0 + i * STEP >= R) break;
      const bool ok = col_ok && r0 + i * STEP < valid_rows;
      cp_async16(dp + i * STEP * LD, ok ? sp : src, ok ? 16 : 0);
      sp += STEP * stride;
    }
    return;
  }
  for (int e = threadIdx.x; e < R * C::CPR; e += kThreads) {
    const int r = e / C::CPR, c = e - r * C::CPR;
    T* d = dst + r * LD + c * C::VEC;
    const bool row_ok = r < valid_rows;
#pragma unroll
    for (int x = 0; x < C::VEC; ++x) {
      const int col = c * C::VEC + x;
      if (row_ok && col < hd)
        d[x] = src[r * stride + col];
      else
        store(d + x, 0.f);
    }
  }
}

// lse and D of queries [i0, i0 + BQ) of one (batch row, head) (row_lse,
// row_delta: its first query) into dst[0, BQ) and dst[BQ, 2 BQ); zeros
// past Sq
template <int BQ>
__device__ __forceinline__ void stage_stats(float* dst, const float* row_lse,
                                            const float* row_delta, int i0,
                                            int Sq) {
  static_assert(2 * BQ <= kThreads, "a thread a value");
  const int t = threadIdx.x;
  if (t < 2 * BQ) {
    const float* src = t < BQ ? row_lse : row_delta;
    const int qi = i0 + t % BQ;
    const bool ok = qi < Sq;
    cp_async4(dst + t, ok ? src + qi : src, ok ? 4 : 0);
  }
}

// a warp's 16 rows of an accumulator times mul into out (row r of the
// CTA at out + r stride), rows [r0, r0 + 16) below `rows` and columns below
// hd; a thread holds rows r0 + g and r0 + g + 8
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* out, long long stride,
                                           const float (&a)[NT][4], float mul,
                                           int r0, int rows, int hd,
                                           int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  const bool pairs = (hd & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half + g;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col >= hd) continue;
      T* p = out + r * stride + col;
      const float x = a[n][2 * half] * mul, y = a[n][2 * half + 1] * mul;
      if (pairs) {
        store2(p, x, y);
      } else {
        store(p, x);
        if (col + 1 < hd) store(p + 1, y);
      }
    }
  }
}

// c = A B^T over the head, for one warp: A its 16 rows (a: the first,
// row stride LD; or, with AREGS, the A fragments af), B rows [0, 8 NB) of
// b.  A thread holds c[n] = rows g and g + 8, columns 8 n + 2 t4 and
// + 1.  bf16: one mma.m16n8k16 a 16-column step.  float32: each operand
// split in three TF32 pieces as it is read, six mma.m16n8k8 an 8-column
// step; k-index t4 of a step reads head column 2 t4 and t4 + 4 column
// 2 t4 + 1 (a thread's two values of a row are one 8-byte load).  Every SF
// steps sum into a fresh accumulator, added to c in float32.
template <typename T, int HD, int NB, bool AREGS>
__device__ __forceinline__ void scores(
    float (&c)[NB][4], const uint32_t (&af)[AREGS ? HD / 16 : 1][4],
    const T* a, const T* b, int lane) {
  using C = Cfg<T, HD>;
  constexpr int LD = C::LD, SF = C::SF;
  constexpr int KS = HD / (C::kBf16 ? 16 : 8);   // k-steps
  static_assert(KS % SF == 0, "whole chunks of steps");
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
  if constexpr (C::kBf16) {
    static_assert(NB % 2 == 0, "n-tiles in pairs");
#pragma unroll
    for (int kc = 0; kc < KS / SF; ++kc) {
      float f[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < SF; ++j) {
        const int kk = kc * SF + j;
        uint32_t x[4];
        if constexpr (AREGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) x[e] = af[kk][e];
        } else {
          ldsm_x4(x, a + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int nn = 0; nn < NB / 2; ++nn) {
          uint32_t bb[4];
          ldsm_x4(bb, b + (nn * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(f[2 * nn], x, bb[0], bb[1]);
          mma_bf16(f[2 * nn + 1], x, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] += f[n][e];
    }
  } else {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float* ar =
          reinterpret_cast<const float*>(a) + g * LD + 2 * t4 + kk * 8;
      const float* br =
          reinterpret_cast<const float*>(b) + g * LD + 2 * t4 + kk * 8;
      uint32_t x[4][3], y[NB][2][3];
      split3_tf32(ar[0], x[0]);
      split3_tf32(ar[8 * LD], x[1]);
      split3_tf32(ar[1], x[2]);
      split3_tf32(ar[8 * LD + 1], x[3]);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const float2 v = *reinterpret_cast<const float2*>(br + n * 8 * LD);
        split3_tf32(v.x, y[n][0]);
        split3_tf32(v.y, y[n][1]);
      }
      float f[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[n][e] = 0.f;
#pragma unroll
      for (int t = 0; t < 6; ++t) {
        const int ia = term_a(t), ib = term_b(t);
        const uint32_t xa[4] = {x[0][ia], x[1][ia], x[2][ia], x[3][ia]};
#pragma unroll
        for (int n = 0; n < NB; ++n)
          mma_tf32(f[n], xa, y[n][0][ib], y[n][1][ib]);
      }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] += f[n][e];
    }
  }
}

// o += W M for one warp: W [16 x 8 NB] in float32 registers as scores()
// leaves them (the accumulator layout, which is the A operand's), M rows
// [0, 8 NB) of m, [8 NB][HD] with row stride LD, read through
// ldmatrix.trans (bf16) or by hand (float32).  bf16: W in kPieces bf16
// pieces, the smallest first, a fresh accumulator for each 8 output
// columns over the tile.  float32: W and M in three TF32 pieces, six
// products; W's k-index t4 holds column 2 t4 and t4 + 4 column 2 t4 + 1
// (where the accumulator holds them, so M's B fragments read those rows);
// a fresh accumulator every 8 rows of M.
template <typename T, int HD, int NB>
__device__ __forceinline__ void accumulate(float (&o)[HD / 8][4],
                                           const float (&w)[NB][4],
                                           const T* m, int lane) {
  using C = Cfg<T, HD>;
  constexpr int LD = C::LD;
  if constexpr (C::kBf16) {
    constexpr int KS = NB / 2;   // 16-row steps of M
    uint32_t p[KS][kPieces][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t x[4][kPieces];
      split_bf16(w[2 * kk][0], w[2 * kk][1], x[0]);
      split_bf16(w[2 * kk][2], w[2 * kk][3], x[1]);
      split_bf16(w[2 * kk + 1][0], w[2 * kk + 1][1], x[2]);
      split_bf16(w[2 * kk + 1][2], w[2 * kk + 1][3], x[3]);
#pragma unroll
      for (int i = 0; i < kPieces; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[kk][i][e] = x[e][i];
    }
#pragma unroll
    for (int nn = 0; nn < HD / 16; ++nn) {
      float f0[4] = {0.f, 0.f, 0.f, 0.f}, f1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bb[4];
        ldsm_x4_t(bb, m + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                              LD +
                          nn * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < kPieces; ++i) {
          mma_bf16(f0, p[kk][i], bb[0], bb[1]);
          mma_bf16(f1, p[kk][i], bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[2 * nn][e] += f0[e];
        o[2 * nn + 1][e] += f1[e];
      }
    }
  } else {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      uint32_t x[4][3];
      split3_tf32(w[kk][0], x[0]);
      split3_tf32(w[kk][2], x[1]);
      split3_tf32(w[kk][1], x[2]);
      split3_tf32(w[kk][3], x[3]);
      const float* mr =
          reinterpret_cast<const float*>(m) + (kk * 8 + 2 * t4) * LD + g;
#pragma unroll
      for (int n0 = 0; n0 < HD / 8; n0 += 2) {
        float f[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        uint32_t y[2][2][3];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          split3_tf32(mr[(n0 + n) * 8], y[n][0]);
          split3_tf32(mr[LD + (n0 + n) * 8], y[n][1]);
        }
#pragma unroll
        for (int t = 0; t < 6; ++t) {
          const int ia = term_a(t), ib = term_b(t);
          const uint32_t xa[4] = {x[0][ia], x[1][ia], x[2][ia], x[3][ia]};
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma_tf32(f[n], xa, y[n][0][ib], y[n][1][ib]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n0 + n][e] += f[n][e];
      }
    }
  }
}

// (i): dq, and each row's log-sum-exp (base 2, of the scores scaled by
// sscale = scale * log2(e)) and D for (ii).  lse and delta are [B, H, Sq]
// float32.  Warp w owns the CTA's rows [16 w, 16 w + 16), a thread rows
// 16 w + g and 16 w + g + 8 of them.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          T* __restrict__ dq, float* __restrict__ lse_out,
          float* __restrict__ delta_out, int Sq, int Skv, int H, int KV,
          int hd, int window, int q_offset, float sscale, float scale,
          int vec) {
  using C = Cfg<T, HD>;
  constexpr int BK = C::BK, LD = C::LD, NT = C::NT;
  constexpr int ST = BK / 8;   // 8-key tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);   // [kRows][LD]
  T* dos = qs + kRows * LD;                  // [kRows][LD]
  T* ks = dos + kRows * LD;                  // [2][BK][LD]
  T* vs = ks + 2 * BK * LD;                  // [2][BK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // long rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_row = (long long)H * hd, kv_row = (long long)KV * hd;
  const long long q_at = ((long long)b * Sq + q0) * q_row + (long long)h * hd;
  const T* kb = k + (long long)b * Skv * kv_row + (long long)kvh * hd;
  const T* vb = v + (long long)b * Skv * kv_row + (long long)kvh * hd;
  const int rows = min(kRows, Sq - q0);
  const bool vok = vec != 0;

  // the keys this tile's rows can see: [lo, hi), in KV tiles
  const int first_pos = q_offset + q0, last_pos = first_pos + rows - 1;
  const int hi = min(Skv, last_pos + 1);
  const int lo = window > 0 ? max(0, first_pos - window + 1) : 0;
  const int t_lo = lo / BK, n_tiles = (hi + BK - 1) / BK - t_lo;

  stage<T, HD, kRows>(qs, q + q_at, q_row, rows, hd, vok);
  stage<T, HD, kRows>(dos, dout + q_at, q_row, rows, hd, vok);
  stage<T, HD, BK>(ks, kb + (long long)t_lo * BK * kv_row, kv_row,
                   Skv - t_lo * BK, hd, vok);
  stage<T, HD, BK>(vs, vb + (long long)t_lo * BK * kv_row, kv_row,
                   Skv - t_lo * BK, hd, vok);
  cp_async_commit();

  // this warp's rows, and this thread's two (g and g + 8)
  const int wr = 16 * warp;
  const bool live = wr < rows;
  const int w_lo = first_pos + wr;
  const int w_hi = first_pos + min(rows, wr + 16) - 1;
  const int pos0 = w_lo + g;
  // the first loop's online softmax and O, then the second loop's dq
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float lse[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f}, acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[C::kQRegs ? HD / 16 : 1][4];
  const uint32_t none[1][4] = {{0u, 0u, 0u, 0u}};

  // the visible tiles twice: it < n_tiles the first loop, then the second
  for (int it = 0; it < 2 * n_tiles; ++it) {
    const bool grad = it >= n_tiles;
    const int kv0 = (t_lo + it - (grad ? n_tiles : 0)) * BK, stg = it & 1;
    if (it + 1 < 2 * n_tiles) {   // the next tile loads while this one runs
      const int nx = it + 1;
      const int nk = (t_lo + nx - (nx >= n_tiles ? n_tiles : 0)) * BK;
      stage<T, HD, BK>(ks + (stg ^ 1) * BK * LD, kb + (long long)nk * kv_row,
                       kv_row, Skv - nk, hd, vok);
      stage<T, HD, BK>(vs + (stg ^ 1) * BK * LD, vb + (long long)nk * kv_row,
                       kv_row, Skv - nk, hd, vok);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (C::kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          ldsm_x4(qf[kk], qs + (wr + (lane & 15)) * LD + kk * 16 +
                              (lane >> 4) * 8);
      }
    }
    if (it == n_tiles) {   // the first loop's end: lse and D of each row
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float lt = l[half];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const int r = wr + 8 * half + g;
        const T* dr = dos + r * LD + 2 * t4;
        float part = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          part += acc[n][2 * half] * widen(dr[n * 8]) +
                  acc[n][2 * half + 1] * widen(dr[n * 8 + 1]);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        lse[half] = m[half] + log2f(lt);
        dlt[half] = part / lt;
        if (t4 == 0 && live && r < rows) {
          const long long at = ((long long)b * H + h) * Sq + q0 + r;
          lse_out[at] = lse[half];
          delta_out[at] = dlt[half];
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    }
    // does any of this warp's rows see a key of the tile?  all of them?
    const bool any = live && kv0 <= w_hi &&
                     (window <= 0 || kv0 + BK - 1 > w_lo - window);
    if (any) {
      const bool full = kv0 + BK - 1 <= w_lo && kv0 + BK <= Skv &&
                        (window <= 0 || kv0 > w_hi - window);
      const T* kt = ks + stg * BK * LD;
      const T* vt = vs + stg * BK * LD;
      float s[ST][4];
      scores<T, HD, ST, C::kQRegs>(s, qf, qs + wr * LD, kt, lane);
      // masked (one branch, off the diagonal and the window's edge not
      // taken), then in log2 units
      if (!full) {
#pragma unroll
        for (int n = 0; n < ST; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kv0 + n * 8 + 2 * t4 + (e & 1);
            const int pos = pos0 + (e < 2 ? 0 : 8);
            if (key > pos || key >= Skv ||
                (window > 0 && key <= pos - window))
              s[n][e] = -INFINITY;
          }
      }
#pragma unroll
      for (int n = 0; n < ST; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= sscale;
      if (!grad) {
        // the rows' running max and sums (O += P V below)
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < ST; ++n) {
          mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
        }
        float ref[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float mn = fmaxf(m[i], mx[i]);
          // a row that has seen no key yet keeps p = 0 (exp2(-inf - 0))
          ref[i] = mn == -INFINITY ? 0.f : mn;
          corr[i] = ex2(m[i] - ref[i]);
          m[i] = mn;
        }
#pragma unroll
        for (int n = 0; n < ST; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] = ex2(s[n][e] - ref[e >> 1]);
            rs[e >> 1] += s[n][e];
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
      } else {
        // dP = dout V^T, dS = P (dP - D)
        float dp[ST][4];
        scores<T, HD, ST, false>(dp, none, dos + wr * LD, vt, lane);
#pragma unroll
        for (int n = 0; n < ST; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = ex2(s[n][e] - lse[e >> 1]) *
                      (dp[n][e] - dlt[e >> 1]);
      }
      accumulate<T, HD, ST>(acc, s, grad ? kt : vt, lane);   // O or dq
    }
    __syncthreads();   // every read of this stage is done
  }

  store_rows<T, NT>(dq + q_at, q_row, acc, scale, wr, rows, hd, lane);
}

// (ii): dk and dv of 64 keys of one KV head, over its G heads.  Warp w
// owns the CTA's keys [16 w, 16 w + 16), a thread keys 16 w + g and
// 16 w + g + 8 of them; the scores' columns are queries.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H,
           int KV, int hd, int window, int q_offset, float sscale,
           float scale, int vec) {
  using C = Cfg<T, HD>;
  constexpr int BQ = C::BQ, LD = C::LD, NT = C::NT;
  constexpr int ST = BQ / 8;   // 8-query tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);   // [kRows][LD]
  T* vs = ks + kRows * LD;                   // [kRows][LD]
  T* qs = vs + kRows * LD;                   // [2][BQ][LD]
  T* dos = qs + 2 * BQ * LD;                 // [2][BQ][LD]
  float* stats = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][2][BQ]

  const int j0 = blockIdx.x * kRows, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long q_row = (long long)H * hd, kv_row = (long long)KV * hd;
  const long long kv_at =
      ((long long)b * Skv + j0) * kv_row + (long long)kvh * hd;
  const int keys = min(kRows, Skv - j0);
  const bool vok = vec != 0;

  // the query rows that see some key of the tile: [lo, hi), in tiles;
  // the work is every (head of the group, query tile)
  const int lo = max(0, j0 - q_offset);
  const int hi = window > 0 ? min(Sq, j0 + keys - 1 + window - q_offset)
                            : Sq;
  const int t_lo = lo / BQ;
  const int n_qt = max(0, (hi + BQ - 1) / BQ - t_lo);
  const int n_items = G * n_qt;

  // item `it` into stage `stg`: Q and dout rows, lse and D
  auto stage_item = [&](int it, int stg) {
    const int hh = kvh * G + it / n_qt;
    const int i0 = (t_lo + it % n_qt) * BQ;
    const long long q_at =
        ((long long)b * Sq + i0) * q_row + (long long)hh * hd;
    stage<T, HD, BQ>(qs + stg * BQ * LD, q + q_at, q_row, Sq - i0, hd, vok);
    stage<T, HD, BQ>(dos + stg * BQ * LD, dout + q_at, q_row, Sq - i0, hd,
                     vok);
    const long long row_at = ((long long)b * H + hh) * Sq;
    stage_stats<BQ>(stats + stg * 2 * BQ, lse + row_at, delta + row_at, i0,
                    Sq);
  };
  stage<T, HD, kRows>(ks, k + kv_at, kv_row, keys, hd, vok);
  stage<T, HD, kRows>(vs, v + kv_at, kv_row, keys, hd, vok);
  if (n_items > 0) stage_item(0, 0);
  cp_async_commit();

  // this warp's keys [k_lo, k_lo + 16)
  const int wk = 16 * warp;
  const bool live = wk < keys;
  const int k_lo = j0 + wk, k_hi = j0 + min(keys, wk + 16) - 1;
  const bool kfull = wk + 16 <= keys;
  // dv's and dk's accumulators; with two sweeps dva holds dv, then dk
  constexpr bool kTwo = C::kTwoSweeps;
  float dva[NT][4], dka[kTwo ? 1 : NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < (kTwo ? 1 : NT); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = 0.f;
  const uint32_t none[1][4] = {{0u, 0u, 0u, 0u}};

  const int total = (kTwo ? 2 : 1) * n_items;
  for (int it = 0; it < total; ++it) {
    const bool second = kTwo && it >= n_items;   // the dk sweep
    const int item = it - (second ? n_items : 0), stg = it & 1;
    if (it + 1 < total) {   // the next item loads while this one runs
      const int nx = it + 1;
      stage_item(nx - (nx >= n_items ? n_items : 0), stg ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kTwo && it == n_items) {   // dv is done: the registers take dk
      store_rows<T, NT>(dv + kv_at, kv_row, dva, 1.f, wk, keys, hd, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dva[n][e] = 0.f;
    }
    const int i0 = (t_lo + item % n_qt) * BQ;
    const int p_lo = q_offset + i0;
    const int p_hi = q_offset + min(i0 + BQ, Sq) - 1;
    // does some query of the tile see a key of this warp?  all of them all?
    const bool any = live && p_hi >= k_lo &&
                     (window <= 0 || p_lo <= k_hi + window - 1);
    if (any) {
      const bool full = kfull && i0 + BQ <= Sq && p_lo >= k_lo + 15 &&
                        (window <= 0 || p_hi - k_lo < window);
      const T* qt = qs + stg * BQ * LD;
      const T* dt = dos + stg * BQ * LD;
      const float* ls = stats + stg * 2 * BQ;
      float s[ST][4];
      scores<T, HD, ST, false>(s, none, ks + wk * LD, qt, lane);
      if (!full) {
#pragma unroll
        for (int n = 0; n < ST; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k_lo + g + (e < 2 ? 0 : 8);
            const int qi = i0 + n * 8 + 2 * t4 + (e & 1);
            const int pos = q_offset + qi;
            if (qi >= Sq || key >= Skv || key > pos ||
                (window > 0 && key <= pos - window))
              s[n][e] = -INFINITY;
          }
      }
      // P^T = exp2(S^T - lse), dv += P^T dout
#pragma unroll
      for (int n = 0; n < ST; ++n) {
        const float2 lq =
            *reinterpret_cast<const float2*>(ls + n * 8 + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = ex2(s[n][e] * sscale - ((e & 1) ? lq.y : lq.x));
      }
      if (!second) accumulate<T, HD, ST>(dva, s, dt, lane);
      if (!kTwo || second) {
        // dS^T = P^T (dP^T - D), dk += dS^T Q
        float dp[ST][4];
        scores<T, HD, ST, false>(dp, none, vs + wk * LD, dt, lane);
#pragma unroll
        for (int n = 0; n < ST; ++n) {
          const float2 dd =
              *reinterpret_cast<const float2*>(ls + BQ + n * 8 + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[n][e] = s[n][e] * (dp[n][e] - ((e & 1) ? dd.y : dd.x));
        }
        if constexpr (kTwo)
          accumulate<T, HD, ST>(dva, dp, qt, lane);
        else
          accumulate<T, HD, ST>(dka, dp, qt, lane);
      }
    }
    __syncthreads();   // every read of this stage is done
  }
  cp_async_wait<0>();   // no item: K and V were staged for nothing

  if constexpr (kTwo) {
    if (n_items == 0)   // no query sees these keys: dv = dk = 0
      store_rows<T, NT>(dv + kv_at, kv_row, dva, 1.f, wk, keys, hd, lane);
    store_rows<T, NT>(dk + kv_at, kv_row, dva, scale, wk, keys, hd, lane);
  } else {
    store_rows<T, NT>(dv + kv_at, kv_row, dva, 1.f, wk, keys, hd, lane);
    store_rows<T, NT>(dk + kv_at, kv_row, dka, scale, wk, keys, hd, lane);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  int B, Sq, Skv, H, KV, hd, window, q_offset;
  float sscale, scale;
  int vec;
};

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               int B, int Sq, int Skv, int H, int KV, int hd, int window,
               int q_offset, float scale, int bf16) {
  // 16-byte rows and bases for cp.async, else element-wise staging
  const auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = (hd * (bf16 ? 2 : 4)) % 16 == 0 && al16(q) && al16(k) &&
                  al16(v) && al16(dout);
  return Args{q, k, v, dout, B, Sq, Skv, H, KV, hd, window, q_offset,
              scale * kLog2e, scale, vec};
}

template <typename T, int HD>
int launch_dq(const Args& a, void* dq, float* lse, float* delta,
              cudaStream_t st) {
  constexpr size_t smem = Cfg<T, HD>::kDqSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kRows - 1) / kRows, a.H, a.B);
  dq_kernel<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<T*>(dq), lse, delta, a.Sq, a.Skv, a.H, a.KV, a.hd,
      a.window, a.q_offset, a.sscale, a.scale, a.vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkv(const Args& a, const float* lse, const float* delta,
               void* dk, void* dv, cudaStream_t st) {
  constexpr size_t smem = Cfg<T, HD>::kDkvSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Skv + kRows - 1) / kRows, a.KV, a.B);
  dkv_kernel<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), a.Sq, a.Skv, a.H, a.KV,
      a.hd, a.window, a.q_offset, a.sscale, a.scale, a.vec);
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

// ---- float32 at few query rows: the rows bodies (float64 inside) ---------
//
// Where a float32 call has at most kRowsMax query rows a KV head (Sq G: a
// decode row), dv and dk at a key are one product or a few, so the error
// of each P is the result's, and the tiles above (the online softmax,
// exp2 of scores scaled by log2 e, three TF32 pieces) sit near twice the
// plain version's error; so did these bodies in float32 (FFMA in the
// plain version's order of operations, measured: 3 of 210 cases over).
// So they compute each row in float64 from the float32 inputs, the plain
// version's formula: s = <q, k> scale, the row's exact maximum over its
// visible keys before any exp, l = sum exp(s - m), lse = m + log(l),
// P = exp(s - lse), O = P V, D = <dout, O>, dS = P (dP - D), and round
// each output to float32 once: the float32 rounding of the result, below
// the plain version's own error.  A dot product is one warp's: lane l
// sums head columns l, l + 32, ... with fma from zero, then an xor
// butterfly, so every lane holds the same bits and both bodies compute
// the same s and P.  lse and D pass between them in float64, and the
// scale hd^-0.5 comes from the wrapper in float64 (no division or square
// root in the bodies, whose slow paths would take a stack frame).  No
// atomics: a repeat is bit for bit.
//   rows_q_f64: one CTA per (query row, head, batch row), a thread per
//     head column: the maximum, then l, then O over chunks of kRowKeys
//     keys (P staged in shared memory), then dP, dS and dq; writes lse
//     and D for rows_kv_f64.
//   rows_kv_f64: one CTA per (kRowKeys keys, KV head, batch row): P and dS
//     of every (row, key) pair of the tile into shared memory (a warp a
//     pair), then a thread per head column sums dv and dk over the rows
//     in the order g Sq + i.
// Bound: each (row, visible key) pair costs 4 hd operations of dots (S
// in each body, dP in each) and 4 hd of sums, in float64 FMA (the H100's
// 34 TFLOP/s outside the tensor cores).  The training path is bf16 and
// never takes these bodies.
constexpr int kRowsMax = 64;      // query rows (Sq G) a KV head at most
constexpr int kRowKeys = 16;      // keys a chunk (q) or a CTA (kv)
constexpr int kRowWarps = 8;
constexpr int kRowThreads = 32 * kRowWarps;   // one a head column

__device__ __forceinline__ double warp_dot(const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           int hd, int lane) {
  double s = 0.0;
  for (int c = lane; c < hd; c += 32)
    s = fma(static_cast<double>(x[c]), static_cast<double>(y[c]), s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// the CTA's max (sum, for !MAX) of one value a warp (each lane the same)
template <bool MAX>
__device__ __forceinline__ double cta_reduce(double x, double* red) {
  const int warp = threadIdx.x >> 5;
  __syncthreads();   // red free from an earlier reduction
  if ((threadIdx.x & 31) == 0) red[warp] = x;
  __syncthreads();
  double r = red[0];
#pragma unroll
  for (int w = 1; w < kRowWarps; ++w) r = MAX ? fmax(r, red[w]) : r + red[w];
  return r;
}

// log(x) for x >= 1 in float64: two Newton steps on exp(y) = x from
// float32's logf (quadratic: 1e-7 -> 1e-13 -> float64's rounding); the
// library's float64 log takes a stack frame that spills
__device__ __forceinline__ double log_f64(double x) {
  double y = logf(static_cast<float>(x));
  y = y - 1.0 + x * exp(-y);
  return y - 1.0 + x * exp(-y);
}

__device__ __forceinline__ void visible(int p, int Skv, int window, int& lo,
                                        int& hi) {
  hi = min(Skv, p + 1);
  lo = window > 0 ? max(0, p - window + 1) : 0;
}

__global__ void __launch_bounds__(kRowThreads)
rows_q_f64(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           float* __restrict__ dq, double* __restrict__ lse_out,
           double* __restrict__ delta_out, int Sq, int Skv, int H, int KV,
           int hd, int window, int q_offset, double scale) {
  __shared__ float qs[kRowThreads], dos[kRowThreads];
  __shared__ double ps[kRowKeys];
  __shared__ double red[kRowWarps];
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row = (((long long)b * Sq + i) * H + h) * hd;
  if (tid < hd) {
    qs[tid] = q[row + tid];
    dos[tid] = dout[row + tid];
  }
  __syncthreads();
  const long long kstride = (long long)KV * hd;
  const long long base = ((long long)b * Skv * KV + h / (H / KV)) * hd;
  const float* kb = k + base;
  const float* vb = v + base;
  int lo, hi;
  visible(q_offset + i, Skv, window, lo, hi);

  double m = -INFINITY;
  for (int j = lo + warp; j < hi; j += kRowWarps)
    m = fmax(m, warp_dot(qs, kb + j * kstride, hd, lane) * scale);
  m = cta_reduce<true>(m, red);
  double l = 0.0;
  for (int j = lo + warp; j < hi; j += kRowWarps)
    l += exp(warp_dot(qs, kb + j * kstride, hd, lane) * scale - m);
  l = cta_reduce<false>(l, red);
  // one thread takes the log (all of them at once made ptxas spill)
  __shared__ double lse_s;
  if (tid == 0) lse_s = m + log_f64(l);
  __syncthreads();
  const double lse = lse_s;

  double o = 0.0;
  for (int j0 = lo; j0 < hi; j0 += kRowKeys) {
    const int n = min(kRowKeys, hi - j0);
    for (int t = warp; t < n; t += kRowWarps) {
      const double s = warp_dot(qs, kb + (j0 + t) * kstride, hd, lane) * scale;
      if (lane == 0) ps[t] = exp(s - lse);
    }
    __syncthreads();
    if (tid < hd)
      for (int t = 0; t < n; ++t)
        o = fma(ps[t], static_cast<double>(vb[(j0 + t) * kstride + tid]), o);
    __syncthreads();
  }
  // D = <dout, O> with O in float64: each thread's product, then the CTA
  double D = tid < hd ? static_cast<double>(dos[tid]) * o : 0.0;
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) D += __shfl_xor_sync(0xffffffffu, D, x);
  D = cta_reduce<false>(D, red);

  double acc = 0.0;
  for (int j0 = lo; j0 < hi; j0 += kRowKeys) {
    const int n = min(kRowKeys, hi - j0);
    for (int t = warp; t < n; t += kRowWarps) {
      const long long off = (j0 + t) * kstride;
      const double s = warp_dot(qs, kb + off, hd, lane) * scale;
      const double dp = warp_dot(dos, vb + off, hd, lane);
      if (lane == 0) ps[t] = exp(s - lse) * (dp - D);
    }
    __syncthreads();
    if (tid < hd)
      for (int t = 0; t < n; ++t)
        acc = fma(ps[t], static_cast<double>(kb[(j0 + t) * kstride + tid]),
                  acc);
    __syncthreads();
  }
  if (tid < hd) dq[row + tid] = static_cast<float>(acc * scale);
  if (tid == 0) {
    const long long st = ((long long)b * H + h) * Sq + i;
    lse_out[st] = lse;
    delta_out[st] = D;
  }
}

__global__ void __launch_bounds__(kRowThreads)
rows_kv_f64(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const double* __restrict__ lse, const double* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv,
            int H, int KV, int hd, int window, int q_offset, double scale) {
  __shared__ double pt[kRowsMax][kRowKeys], dst[kRowsMax][kRowKeys];
  const int kvh = blockIdx.y, b = blockIdx.z, G = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.x * kRowKeys, nk = min(kRowKeys, Skv - j0);
  const int R = G * Sq;
  const long long kstride = (long long)KV * hd;
  const long long base = ((long long)b * Skv * KV + kvh) * hd;
  // row r = g Sq + i: query i of head kvh G + g
  auto qrow = [&](int r) {
    const int g = r / Sq, i = r - g * Sq;
    return (((long long)b * Sq + i) * H + kvh * G + g) * hd;
  };
  for (int e = warp; e < R * kRowKeys; e += kRowWarps) {
    const int r = e / kRowKeys, t = e - r * kRowKeys;
    const int g = r / Sq, i = r - g * Sq, j = j0 + t;
    int lo, hi;
    visible(q_offset + i, Skv, window, lo, hi);
    double p = 0.0, ds = 0.0;
    if (t < nk && j >= lo && j < hi) {
      const long long qr = qrow(r), off = base + j * kstride;
      const long long st = ((long long)b * H + kvh * G + g) * Sq + i;
      const double s = warp_dot(q + qr, k + off, hd, lane) * scale;
      const double dp = warp_dot(dout + qr, v + off, hd, lane);
      p = exp(s - lse[st]);
      ds = p * (dp - delta[st]);
    }
    if (lane == 0) {
      pt[r][t] = p;
      dst[r][t] = ds;
    }
  }
  __syncthreads();
  if (tid >= hd) return;
  double av[kRowKeys], ak[kRowKeys];
#pragma unroll
  for (int t = 0; t < kRowKeys; ++t) av[t] = ak[t] = 0.0;
  for (int r = 0; r < R; ++r) {
    const long long qr = qrow(r) + tid;
    const double dov = dout[qr], qv = q[qr];
#pragma unroll
    for (int t = 0; t < kRowKeys; ++t) {
      av[t] = fma(pt[r][t], dov, av[t]);
      ak[t] = fma(dst[r][t], qv, ak[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < kRowKeys; ++t) {
    if (t >= nk) break;
    const long long off = base + (j0 + t) * kstride + tid;
    dv[off] = static_cast<float>(av[t]);
    dk[off] = static_cast<float>(ak[t] * scale);
  }
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
  const Args a = make_args(q, k, v, dout, B, Sq, Skv, H, KV, hd, window,
                           q_offset, scale, bf16);
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
  const Args a = make_args(q, k, v, dout, B, Sq, Skv, H, KV, hd, window,
                           q_offset, scale, bf16);
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

// The float32 rows bodies (few query rows, Sq * H / KV <= 64), in the
// layouts of (i) and (ii): dq, lse and delta (float64 here), then dk and
// dv.
extern "C" int repro_flash_bwd_rows_dq(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       void* dq, void* lse, void* delta,
                                       int B, int Sq, int Skv, int H, int KV,
                                       int hd, int window, int q_offset,
                                       double scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if (bad_shape(B, Sq, Skv, H, KV, hd) || Sq * (H / KV) > kRowsMax)
    return static_cast<int>(cudaErrorInvalidValue);
  rows_q_f64<<<dim3(Sq, H, B), kRowThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<float*>(dq), static_cast<double*>(lse),
      static_cast<double*>(delta), Sq, Skv, H, KV, hd, window, q_offset,
      scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_flash_bwd_rows_dkv(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, int B, int Sq,
                                        int Skv, int H, int KV, int hd,
                                        int window, int q_offset,
                                        double scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if (bad_shape(B, Sq, Skv, H, KV, hd) || Sq * (H / KV) > kRowsMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Skv + kRowKeys - 1) / kRowKeys, KV, B);
  rows_kv_f64<<<grid, kRowThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const double*>(lse), static_cast<const double*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Skv, H, KV, hd,
      window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local bytes a thread of the rows bodies, in the order of
// kernels/flash_attention.py BWD_ROWS_BODIES: rows_q_f64, rows_kv_f64.
extern "C" int repro_flash_bwd_rows_attrs(int which, int* regs,
                                          int* local_bytes) {
  static const void* const bodies[] = {
      reinterpret_cast<const void*>(rows_q_f64),
      reinterpret_cast<const void*>(rows_kv_f64)};
  if (which < 0 || which >= 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, bodies[which]);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
