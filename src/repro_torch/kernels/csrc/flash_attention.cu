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
// j > q_offset + i - window.  The reference widens every element to
// float32 and computes in float32; the output is rounded once to the input
// type.  The caller guarantees that every query row sees a key.
//
// Bounds on the H100.  A 4,096-token causal prefill at OLMo-1B's width (16
// heads of 128) multiplies 16 x 8.4M visible (query, key) pairs by 4 x 128
// operations: 68.7 GFLOP, 0.0695 ms at the 989 TFLOP/s of the bf16 tensor
// cores (1.0 ms at 67 TFLOP/s outside them), against 67 MB of q, k, v and
// out.  A decode step (Sq = 1) reads the whole KV cache for a few products
// a byte: 8 sequences of 32,768 keys are 2.15 GB, 0.64 ms at 3.35 TB/s.
// So there are two bodies, chosen by the wrapper (kernels/flash_attention.py
// path()): "tile" for prefill, "split" for decode.
//
// Why the operand splits.  The contract is float32's: within
// 1e-5 * (P @ |V|) of the float32 oracle, plus one rounding of a bf16
// output.  One bf16 rounding of P (what a bf16 fused attention does) is
// 2^-9 of each weight, about 100x over that; one TF32 rounding of P about
// 60x.  So:
//   * bf16 inputs: S = Q K^T is one bf16 product (bf16 x bf16 is exact in
//     float32, the sum is float32), and Q is not pre-scaled (a rounded
//     q * hd^-0.5 would put 2^-9 into every score): the float32 scores are
//     scaled by hd^-0.5 * log2(e) for exp2.  P is split into
//     hi = bf16(p) and lo = bf16(p - hi), so P @ V is two products into
//     one float32 accumulator, good to about 2^-17 of each weight.  The
//     row sums take the float32 p.
//   * float32 inputs: both products are 3xTF32, x = hi + lo with
//     hi = tf32_rna(x), lo = tf32_rna(x - hi), and a.b ~ hi.hi + hi.lo +
//     lo.hi, good to about 2^-21.  tf32_rna is cvt.rna.tf32.f32's rounding
//     (nearest, ties away) done as two integer operations, the same bits;
//     raw float32 bits fed to a tf32 mma would be truncated instead.  q is
//     scaled in float32 before the split, as the reference scales it.
//
// "tile" (FA2 on mma.sync).  One CTA of 4 warps per (64-query tile, q
// head, batch row); each warp owns 16 query rows.  The q tiles run from
// the last to the first, so the longest causal rows start first.  K and V
// tiles stream through a two-stage cp.async ring in shared memory (rows
// padded against bank conflicts; each thread's chunks one column, their
// addresses computed once), the next tile loading while this one is
// multiplied.  The KV tiles a q tile can see are the loop bounds (causal:
// up to the tile of its last query; window: from the tile of its first
// query's first key), a warp skips a tile none of its rows sees, and the
// mask runs only on tiles some row sees in part, so a 1,024-token window
// skips whole tiles.  GQA is an index: head h reads KV head h / G.
//   * bf16: S by mma.m16n8k16 from ldmatrix fragments (Q's held in
//     registers up to hd = 128), P stays in registers as the A operand
//     (the accumulator layout is the A layout), V through ldmatrix.trans.
//   * float32: mma.m16n8k8.tf32 three times per product, fragments loaded
//     by hand.  Within a k-step, k-index t reads head column 2t and t + 4
//     column 2t + 1, so a thread's two K values are one 8-byte load.  The
//     tf32 accumulator layout is not its A layout, so P @ V permutes keys
//     the same way: k-index t holds key 2t and t + 4 key 2t + 1, where the
//     accumulator already holds them, and V's B fragments read those keys.
//   * the head width is padded with zeros to 32, 64, 128 or 256 (exact);
//     the online softmax's (max, sum) and the output stay in float32
//     registers until the one division at the end.
//
// "split" (split-KV decode, Sq * G small).  Each CTA takes one chunk of
// the visible key range of one (KV head, batch row) and up to NQ of its
// query rows (all G heads of a decode step), so every K and V byte is read
// once.  Its 256 threads split into groups of lanes, each group reading
// one key row at a time with 16-byte loads and keeping an online softmax
// per query row on CUDA cores (the work is a few products a byte); the
// groups merge in shared memory and the CTA writes float32 partials
// (m, l, acc[hd]) for its chunk.  A chunk that no row of it sees writes
// m = -inf, l = 0 and weighs 0.  combine_kernel then rescales each row's
// partials by exp(m_c - M) and divides.  The wrapper sizes the chunks so
// that the grid gives every SM several CTAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTileWarps = 4;
constexpr int kTileRows = 16 * kTileWarps;     // query rows a CTA
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kSplitThreads = 256;
constexpr int kCombineThreads = 128;

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
// (x, y) = hi + lo, each a pair of bf16 (x in the low half)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// 2^x to about 2 ulp (-inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --------------------------------------------------------------------------
// "tile": tensor-core prefill
// --------------------------------------------------------------------------

template <typename T, int HD>
struct TileCfg {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int BK = (kBf16 && HD <= 128) ? 64 : 32;   // keys a tile
  static constexpr int VEC = 16 / sizeof(T);   // elements of 16 bytes
  static constexpr int CPR = HD / VEC;         // 16-byte chunks a row
  // row strides in elements, padded against bank conflicts: 16 bytes for
  // bf16 (ldmatrix); for float32, 8 floats where a thread reads two
  // neighbours (q, K) and 4 where it reads one (V)
  static constexpr int LD = HD + 8;
  static constexpr int LDV = kBf16 ? HD + 8 : HD + 4;
  // q's fragments stay in registers (bf16 as loaded, float32 scaled)
  static constexpr bool kQRegs = HD <= 128;
  // q, then two stages of K and of V
  static constexpr size_t kSmem =
      sizeof(T) * static_cast<size_t>((kTileRows + 2 * BK) * LD +
                                      2 * BK * LDV);
};

// rows [0, R) of a [rows][hd] block with row stride `stride` into a padded
// [R][LD] tile; rows past valid_rows and columns past hd are zeros.  With
// vec, each thread copies 16-byte chunks of one column, kTileThreads / CPR
// rows apart, by cp.async; else the elements one at a time.
template <typename T, int HD, int R, int LD>
__device__ __forceinline__ void stage(T* dst, const T* src, long long stride,
                                      int valid_rows, int hd, bool vec) {
  using C = TileCfg<T, HD>;
  if (vec) {
    constexpr int STEP = kTileThreads / C::CPR;
    static_assert(kTileThreads % C::CPR == 0, "a thread keeps its column");
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
  for (int e = threadIdx.x; e < R * C::CPR; e += kTileThreads) {
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

// HD: the head width padded up (hd <= HD, the padding zeros).  qscale
// multiplies q before a float32 product; sscale takes the float32 scores
// to log2 units.  Warp w owns the CTA's rows [16 w, 16 w + 16), and a
// thread rows 16 w + g and 16 w + g + 8 of them.
template <typename T, int HD>
__global__ void __launch_bounds__(kTileThreads, 1)
tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
            int H, int KV, int hd, int window, int q_offset, float qscale,
            float sscale, int vec) {
  using C = TileCfg<T, HD>;
  constexpr int BK = C::BK, LD = C::LD, LDV = C::LDV;
  constexpr int NT = HD / 8;   // 8-column tiles of the output
  constexpr int ST = BK / 8;   // 8-key tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);   // [kTileRows][LD]
  T* ks = qs + kTileRows * LD;               // [2][BK][LD]
  T* vs = ks + 2 * BK * LD;                  // [2][BK][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTileRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_row = (long long)H * hd;    // stride of a query row
  const long long kv_row = (long long)KV * hd;  // stride of a key row
  const T* qb = q + ((long long)b * Sq + q0) * q_row + (long long)h * hd;
  const T* kb = k + (long long)b * Skv * kv_row + (long long)kvh * hd;
  const T* vb = v + (long long)b * Skv * kv_row + (long long)kvh * hd;
  const int rows = min(kTileRows, Sq - q0);
  const bool vok = vec != 0;

  // the keys this tile's rows can see: [lo, hi), in KV tiles
  const int first_pos = q_offset + q0, last_pos = first_pos + rows - 1;
  const int hi = min(Skv, last_pos + 1);
  const int lo = window > 0 ? max(0, first_pos - window + 1) : 0;
  const int t_lo = lo / BK, n_tiles = (hi + BK - 1) / BK - t_lo;

  stage<T, HD, kTileRows, LD>(qs, qb, q_row, rows, hd, vok);
  stage<T, HD, BK, LD>(ks, kb + (long long)t_lo * BK * kv_row, kv_row,
                       Skv - t_lo * BK, hd, vok);
  stage<T, HD, BK, LDV>(vs, vb + (long long)t_lo * BK * kv_row, kv_row,
                        Skv - t_lo * BK, hd, vok);
  cp_async_commit();

  // this warp's rows, and this thread's two (g and g + 8)
  const int wr = 16 * warp;
  const bool live = wr < rows;
  const int w_lo = first_pos + wr;
  const int w_hi = first_pos + min(rows, wr + 16) - 1;
  const int pos0 = w_lo + g;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  uint32_t qf[C::kBf16 && C::kQRegs ? HD / 16 : 1][4];
  float qx[!C::kBf16 && C::kQRegs ? HD / 8 : 1][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = (t_lo + it) * BK, stg = it & 1;
    if (it + 1 < n_tiles) {   // the next tile loads while this one runs
      const int nk = kv0 + BK;
      stage<T, HD, BK, LD>(ks + (stg ^ 1) * BK * LD,
                           kb + (long long)nk * kv_row, kv_row, Skv - nk, hd,
                           vok);
      stage<T, HD, BK, LDV>(vs + (stg ^ 1) * BK * LDV,
                            vb + (long long)nk * kv_row, kv_row, Skv - nk,
                            hd, vok);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (C::kQRegs) {
      if (it == 0) {
        if constexpr (C::kBf16) {
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            ldsm_x4(qf[kk], qs + (wr + (lane & 15)) * LD + kk * 16 +
                                (lane >> 4) * 8);
        } else {
          // k-index t4 of a step reads column 2 t4, t4 + 4 column 2 t4 + 1
          const float* qr =
              reinterpret_cast<const float*>(qs) + (wr + g) * LD + 2 * t4;
#pragma unroll
          for (int kk = 0; kk < HD / 8; ++kk) {
            qx[kk][0] = qr[kk * 8] * qscale;
            qx[kk][1] = qr[8 * LD + kk * 8] * qscale;
            qx[kk][2] = qr[kk * 8 + 1] * qscale;
            qx[kk][3] = qr[8 * LD + kk * 8 + 1] * qscale;
          }
        }
      }
    }
    // does any of this warp's rows see a key of the tile?  all of them?
    const bool any = live && kv0 <= w_hi &&
                     (window <= 0 || kv0 + BK - 1 > w_lo - window);
    if (any) {
      const bool full = kv0 + BK - 1 <= w_lo && kv0 + BK <= Skv &&
                        (window <= 0 || kv0 > w_hi - window);
      const T* kt = ks + stg * BK * LD;
      const T* vt = vs + stg * BK * LDV;
      float s[ST][4];
#pragma unroll
      for (int n = 0; n < ST; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;

      // S = Q K^T
      if constexpr (C::kBf16) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t a[4];
          if constexpr (C::kQRegs) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
          } else {
            ldsm_x4(a, qs + (wr + (lane & 15)) * LD + kk * 16 +
                           (lane >> 4) * 8);
          }
#pragma unroll
          for (int nn = 0; nn < BK / 16; ++nn) {
            uint32_t bb[4];
            ldsm_x4(bb, kt + (nn * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * nn], a, bb[0], bb[1]);
            mma_bf16(s[2 * nn + 1], a, bb[2], bb[3]);
          }
        }
      } else {
        // k-index t4 of a step is column 2 t4, t4 + 4 is 2 t4 + 1: a
        // thread's two values of a row are neighbours
        const float* qr = reinterpret_cast<const float*>(qs) + (wr + g) * LD +
                          2 * t4;
        const float* kr = reinterpret_cast<const float*>(kt) + g * LD + 2 * t4;
#pragma unroll
        for (int kk = 0; kk < HD / 8; ++kk) {
          uint32_t ah[4], al[4];
          if constexpr (C::kQRegs) {
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(qx[kk][e], ah[e], al[e]);
          } else {
            const float* r0 = qr + kk * 8;
            split_tf32(r0[0] * qscale, ah[0], al[0]);
            split_tf32(r0[8 * LD] * qscale, ah[1], al[1]);
            split_tf32(r0[1] * qscale, ah[2], al[2]);
            split_tf32(r0[8 * LD + 1] * qscale, ah[3], al[3]);
          }
          uint32_t bh[ST][2], bl[ST][2];
#pragma unroll
          for (int n = 0; n < ST; ++n) {
            const float2 x =
                *reinterpret_cast<const float2*>(kr + n * 8 * LD + kk * 8);
            split_tf32(x.x, bh[n][0], bl[n][0]);
            split_tf32(x.y, bh[n][1], bl[n][1]);
          }
          // the small products first, each pass over independent tiles
#pragma unroll
          for (int n = 0; n < ST; ++n) mma_tf32(s[n], al, bh[n][0], bh[n][1]);
#pragma unroll
          for (int n = 0; n < ST; ++n) mma_tf32(s[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
          for (int n = 0; n < ST; ++n) mma_tf32(s[n], ah, bh[n][0], bh[n][1]);
        }
      }

      // scores in log2 units, masked (one branch, off the diagonal and the
      // window's edge not taken); the rows' running max and sums
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
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < ST; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= sscale;
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
        for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];

      // O += P V
      if constexpr (C::kBf16) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t ph[4], pl[4];
          split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
          for (int nn = 0; nn < HD / 16; ++nn) {
            uint32_t bb[4];
            ldsm_x4_t(bb, vt + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                (lane & 7)) * LDV +
                              nn * 16 + (lane >> 4) * 8);
            mma_bf16(o[2 * nn], pl, bb[0], bb[1]);
            mma_bf16(o[2 * nn + 1], pl, bb[2], bb[3]);
            mma_bf16(o[2 * nn], ph, bb[0], bb[1]);
            mma_bf16(o[2 * nn + 1], ph, bb[2], bb[3]);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < ST; ++kk) {
          // k-index t4 holds key 2 t4, t4 + 4 holds key 2 t4 + 1
          uint32_t ph[4], pl[4];
          split_tf32(s[kk][0], ph[0], pl[0]);
          split_tf32(s[kk][2], ph[1], pl[1]);
          split_tf32(s[kk][1], ph[2], pl[2]);
          split_tf32(s[kk][3], ph[3], pl[3]);
          const float* v0 = reinterpret_cast<const float*>(vt) +
                            (kk * 8 + 2 * t4) * LDV + g;
#pragma unroll
          for (int n0 = 0; n0 < NT; n0 += 4) {
            uint32_t bh[4][2], bl[4][2];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              split_tf32(v0[(n0 + j) * 8], bh[j][0], bl[j][0]);
              split_tf32(v0[LDV + (n0 + j) * 8], bh[j][1], bl[j][1]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_tf32(o[n0 + j], pl, bh[j][0], bh[j][1]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_tf32(o[n0 + j], ph, bl[j][0], bl[j][1]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_tf32(o[n0 + j], ph, bh[j][0], bh[j][1]);
          }
        }
      }
    }
    __syncthreads();   // every read of this stage is done
  }

  T* ob = out + ((long long)b * Sq + q0) * q_row + (long long)h * hd;
  const bool pairs = (hd & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lt = l[half];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = wr + 8 * half + g;
    if (!live || r >= rows) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col >= hd) continue;
      T* p = ob + r * q_row + col;
      const float x = o[n][2 * half] / lt, y = o[n][2 * half + 1] / lt;
      if (pairs) {
        store2(p, x, y);
      } else {
        store(p, x);
        if (col + 1 < hd) store(p + 1, y);
      }
    }
  }
}

// --------------------------------------------------------------------------
// "split": split-KV decode
// --------------------------------------------------------------------------

template <typename T, int HD, int NQ>
struct SplitCfg {
  static constexpr int VEC = 16 / sizeof(T);          // elements a load
  static constexpr int CH = HD / VEC;                 // 16-byte chunks a row
  static constexpr int LPR = CH < 32 ? CH : 32;       // lanes a key row
  static constexpr int CPL = CH / LPR;                // chunks a lane
  static constexpr int NG = kSplitThreads / LPR;      // lane groups a CTA
  static constexpr int E = CPL * VEC;                 // elements a lane
  // keys a group loads a step: 4 in flight, 2 where the rows' q and
  // accumulators already take 128 registers
  static constexpr int KB = (E * NQ >= 64 || CPL > 1) ? 2 : 4;
  // the groups' (m, l, acc) for the merge
  static constexpr size_t kSmem = sizeof(float) * NG * NQ * (HD + 2);
};

__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // bf16 -> float is a shift: low half first
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// VEC elements of a row from column col0: one 16-byte load (VL: hd is a
// multiple of VEC), else one element at a time; zeros past hd or for an
// invalid row
template <typename T, bool VL>
__device__ __forceinline__ void load_chunk(float* f, const T* row, int col0,
                                           int hd, bool ok) {
  constexpr int VEC = 16 / sizeof(T);
  if constexpr (VL) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (ok && col0 < hd) u = __ldg(reinterpret_cast<const uint4*>(row + col0));
    unpack(u, f, T());
  } else {
#pragma unroll
    for (int x = 0; x < VEC; ++x)
      f[x] = (ok && col0 + x < hd) ? widen(row[col0 + x]) : 0.f;
  }
}

// grid (chunks, KV * row groups, B).  Query rows r = gi * NQ + i of a KV
// head are (query r % Sq, head kvh * G + r / Sq).  Partials of output row
// (b, i, h) and chunk c at ((b * Sq + i) * H + h) * chunks + c.
template <typename T, int HD, int NQ, bool VL>
__global__ void __launch_bounds__(kSplitThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, float* __restrict__ pm,
             float* __restrict__ pl, float* __restrict__ pacc, int Sq,
             int Skv, int H, int KV, int hd, int window, int q_offset,
             int kv_lo, int chunk, int chunks, float scale) {
  using C = SplitCfg<T, HD, NQ>;
  constexpr int VEC = C::VEC, LPR = C::LPR, CPL = C::CPL, NG = C::NG;
  constexpr int KB = C::KB, E = C::E;
  extern __shared__ __align__(16) float sm[];
  float* sm_m = sm;                  // [NG][NQ]
  float* sm_l = sm_m + NG * NQ;      // [NG][NQ]
  float* sm_a = sm_l + NG * NQ;      // [NG][NQ][HD]

  const int tid = threadIdx.x, gi = tid / LPR, li = tid % LPR;
  const int c = blockIdx.x, b = blockIdx.z;
  const int G = H / KV, rows_all = G * Sq;
  const int groups = (rows_all + NQ - 1) / NQ;
  const int kvh = blockIdx.y / groups, r0 = (blockIdx.y % groups) * NQ;
  const int nrows = min(NQ, rows_all - r0);
  const long long kv_row = (long long)KV * hd;
  const T* kb = k + (long long)b * Skv * kv_row + (long long)kvh * hd;
  const T* vb = v + (long long)b * Skv * kv_row + (long long)kvh * hd;
  const int ks = kv_lo + c * chunk, ke = min(Skv, ks + chunk);

  // this lane's slice of each query row, scaled as the reference scales
  float qr[NQ][E];
  int pos[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int r = r0 + i, qi = r % Sq, hq = kvh * G + r / Sq;
    pos[i] = q_offset + qi;
    const T* qrow = q + (((long long)b * Sq + qi) * H + hq) * hd;
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc)
      load_chunk<T, VL>(&qr[i][cc * VEC], qrow, (li + cc * LPR) * VEC, hd,
                        i < nrows);
#pragma unroll
    for (int e = 0; e < E; ++e) qr[i][e] *= scale;
  }

  float m[NQ], l[NQ], acc[NQ][E];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  // every thread takes the same number of steps, so the shuffles below
  // always have all 32 lanes
  for (int s0 = ks; s0 < ke; s0 += NG * KB) {
    const int j0 = s0 + gi * KB;
    float kf[KB][E], vf[KB][E];
#pragma unroll
    for (int kb_ = 0; kb_ < KB; ++kb_) {
      const int j = j0 + kb_;
      const bool ok = j < ke;
      const long long off = (long long)(ok ? j : ks) * kv_row;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int col0 = (li + cc * LPR) * VEC;
        load_chunk<T, VL>(&kf[kb_][cc * VEC], kb + off, col0, hd, ok);
        load_chunk<T, VL>(&vf[kb_][cc * VEC], vb + off, col0, hd, ok);
      }
    }
    float s[KB][NQ];
#pragma unroll
    for (int kb_ = 0; kb_ < KB; ++kb_) {
      const int j = j0 + kb_;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[i][e], kf[kb_][e], d);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        const bool ok = j < ke && i < nrows && j <= pos[i] &&
                        (window <= 0 || j > pos[i] - window);
        s[kb_][i] = ok ? d * kLog2e : -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      float bm = s[0][i];
#pragma unroll
      for (int kb_ = 1; kb_ < KB; ++kb_) bm = fmaxf(bm, s[kb_][i]);
      const float mn = fmaxf(m[i], bm);
      if (mn == -INFINITY) continue;   // no key of this row yet
      const float corr = ex2(m[i] - mn);
      float p[KB], ps = 0.f;
#pragma unroll
      for (int kb_ = 0; kb_ < KB; ++kb_) {
        p[kb_] = ex2(s[kb_][i] - mn);
        ps += p[kb_];
      }
      l[i] = l[i] * corr + ps;
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = acc[i][e] * corr;
#pragma unroll
        for (int kb_ = 0; kb_ < KB; ++kb_) a = fmaf(p[kb_], vf[kb_][e], a);
        acc[i][e] = a;
      }
    }
  }

  // merge the lane groups, then one partial a row
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    if (li == 0) {
      sm_m[gi * NQ + i] = m[i];
      sm_l[gi * NQ + i] = l[i];
    }
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
      for (int x = 0; x < VEC; ++x)
        sm_a[(gi * NQ + i) * HD + (li + cc * LPR) * VEC + x] =
            acc[i][cc * VEC + x];
  }
  __syncthreads();
  for (int e = tid; e < NQ * HD; e += kSplitThreads) {
    const int i = e / HD, col = e - i * HD;
    if (i >= nrows || col >= hd) continue;
    float M = -INFINITY;
    for (int gg = 0; gg < NG; ++gg) M = fmaxf(M, sm_m[gg * NQ + i]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
      for (int gg = 0; gg < NG; ++gg) {
        const float w = ex2(sm_m[gg * NQ + i] - M);
        L += sm_l[gg * NQ + i] * w;
        A += sm_a[(gg * NQ + i) * HD + col] * w;
      }
    }
    const int r = r0 + i, qi = r % Sq, hq = kvh * G + r / Sq;
    const long long pidx = (((long long)b * Sq + qi) * H + hq) * chunks + c;
    pacc[pidx * hd + col] = A;
    if (col == 0) {
      pm[pidx] = M;
      pl[pidx] = L;
    }
  }
}

// one CTA an output row: out = sum_c acc_c w_c / sum_c l_c w_c,
// w_c = exp2(m_c - max m); an empty chunk (m_c = -inf) weighs 0
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
               const float* __restrict__ pacc, T* __restrict__ out, int hd,
               int chunks) {
  const long long row = blockIdx.x;
  const float* m = pm + row * chunks;
  const float* l = pl + row * chunks;
  float M = -INFINITY;
  for (int c = 0; c < chunks; ++c) M = fmaxf(M, m[c]);
  float L = 0.f;
  for (int c = 0; c < chunks; ++c) L += l[c] * ex2(m[c] - M);
  const float* a = pacc + row * chunks * hd;
  for (int col = threadIdx.x; col < hd; col += kCombineThreads) {
    float A = 0.f;
    for (int c = 0; c < chunks; ++c) A += a[c * hd + col] * ex2(m[c] - M);
    store(out + row * hd + col, A / L);
  }
}

// --------------------------------------------------------------------------
// launches
// --------------------------------------------------------------------------

template <typename T, int HD>
int launch_tile(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Skv, int H, int KV, int hd, int window,
                int q_offset, float scale, int vec, cudaStream_t st) {
  constexpr size_t smem = TileCfg<T, HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool bf16 = sizeof(T) == 2;
  const float qscale = bf16 ? 1.f : scale;
  const float sscale = bf16 ? scale * kLog2e : kLog2e;
  const dim3 grid((Sq + kTileRows - 1) / kTileRows, H, B);
  tile_kernel<T, HD><<<grid, kTileThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, KV, hd,
      window, q_offset, qscale, sscale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_tile(const void* q, const void* k, const void* v, void* out,
                  int B, int Sq, int Skv, int H, int KV, int hd, int window,
                  int q_offset, float scale, int vec, cudaStream_t st) {
  if (hd <= 32)
    return launch_tile<T, 32>(q, k, v, out, B, Sq, Skv, H, KV, hd, window,
                              q_offset, scale, vec, st);
  if (hd <= 64)
    return launch_tile<T, 64>(q, k, v, out, B, Sq, Skv, H, KV, hd, window,
                              q_offset, scale, vec, st);
  if (hd <= 128)
    return launch_tile<T, 128>(q, k, v, out, B, Sq, Skv, H, KV, hd, window,
                               q_offset, scale, vec, st);
  return launch_tile<T, 256>(q, k, v, out, B, Sq, Skv, H, KV, hd, window,
                             q_offset, scale, vec, st);
}

struct SplitArgs {
  const void *q, *k, *v;
  float *pm, *pl, *pacc;
  int B, Sq, Skv, H, KV, hd, window, q_offset, kv_lo, chunk, chunks;
  float scale;
};

template <typename T, int HD, int NQ, bool VL>
int launch_split(const SplitArgs& a, cudaStream_t st) {
  constexpr size_t smem = SplitCfg<T, HD, NQ>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel<T, HD, NQ, VL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = ((a.H / a.KV) * a.Sq + NQ - 1) / NQ;
  const dim3 grid(a.chunks, a.KV * groups, a.B);
  split_kernel<T, HD, NQ, VL><<<grid, kSplitThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.pm, a.pl, a.pacc, a.Sq, a.Skv, a.H,
      a.KV, a.hd, a.window, a.q_offset, a.kv_lo, a.chunk, a.chunks, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int split_rows(const SplitArgs& a, int nq, int vec, cudaStream_t st) {
  if (!vec) return launch_split<T, HD, 8, false>(a, st);
  switch (nq) {
    case 1: return launch_split<T, HD, 1, true>(a, st);
    case 2: return launch_split<T, HD, 2, true>(a, st);
    case 4: return launch_split<T, HD, 4, true>(a, st);
    case 8: return launch_split<T, HD, 8, true>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_split(const SplitArgs& a, int nq, int vec, cudaStream_t st) {
  if (a.hd <= 32) return split_rows<T, 32>(a, nq, vec, st);
  if (a.hd <= 64) return split_rows<T, 64>(a, nq, vec, st);
  if (a.hd <= 128) return split_rows<T, 128>(a, nq, vec, st);
  return split_rows<T, 256>(a, nq, vec, st);
}

bool bad_shape(int B, int Sq, int H, int KV, int hd) {
  return hd > 256 || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535 ||
         Sq <= 0;
}

#define REPRO_TILE_BODIES(T)                                       \
  reinterpret_cast<const void*>(tile_kernel<T, 32>),              \
      reinterpret_cast<const void*>(tile_kernel<T, 64>),          \
      reinterpret_cast<const void*>(tile_kernel<T, 128>),         \
      reinterpret_cast<const void*>(tile_kernel<T, 256>)
#define REPRO_SPLIT_HD(T, HD)                                         \
  reinterpret_cast<const void*>(split_kernel<T, HD, 1, true>),       \
      reinterpret_cast<const void*>(split_kernel<T, HD, 2, true>),   \
      reinterpret_cast<const void*>(split_kernel<T, HD, 4, true>),   \
      reinterpret_cast<const void*>(split_kernel<T, HD, 8, true>),   \
      reinterpret_cast<const void*>(split_kernel<T, HD, 8, false>)
#define REPRO_SPLIT_BODIES(T)                                   \
  REPRO_SPLIT_HD(T, 32), REPRO_SPLIT_HD(T, 64), REPRO_SPLIT_HD(T, 128), \
      REPRO_SPLIT_HD(T, 256)

}  // namespace

// q [B, Sq, H, hd], k and v [B, Skv, KV, hd] -> out [B, Sq, H, hd], all
// float32 (bf16 == 0) or all bfloat16 (bf16 == 1), contiguous; hd <= 256,
// H a multiple of KV, B and H at most 65,535.  window <= 0 is causal only.
// vec: every row of q, k and v starts on 16 bytes (cp.async), else the
// tiles load one element at a time.  One launch.
extern "C" int repro_flash_tile(const void* q, const void* k, const void* v,
                                void* out, int B, int Sq, int Skv, int H,
                                int KV, int hd, int window, int q_offset,
                                float scale, int bf16, int vec,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || H == 0 || hd == 0)
    return static_cast<int>(cudaGetLastError());
  if (bad_shape(B, Sq, H, KV, hd))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return dispatch_tile<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KV, hd,
                                        window, q_offset, scale, vec, st);
  return dispatch_tile<float>(q, k, v, out, B, Sq, Skv, H, KV, hd, window,
                              q_offset, scale, vec, st);
}

// The split path's first launch: the partials of each (chunk, KV head,
// group of nq query rows, batch row), chunks of `chunk` keys from kv_lo.
// pm, pl [B * Sq * H * chunks], pacc [B * Sq * H * chunks * hd] float32.
// nq is 1, 2, 4 or 8 (8 when vec is 0).
extern "C" int repro_flash_split(const void* q, const void* k, const void* v,
                                 void* pm, void* pl, void* pacc, int B,
                                 int Sq, int Skv, int H, int KV, int hd,
                                 int window, int q_offset, int kv_lo,
                                 int chunk, int chunks, int nq, float scale,
                                 int bf16, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || H == 0 || hd == 0)
    return static_cast<int>(cudaGetLastError());
  const int groups = KV > 0 ? ((H / KV) * Sq + nq - 1) / nq : 0;
  if (bad_shape(B, Sq, H, KV, hd) || chunks <= 0 || chunk <= 0 ||
      (long long)KV * groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs a{q, k, v, static_cast<float*>(pm), static_cast<float*>(pl),
                    static_cast<float*>(pacc), B, Sq, Skv, H, KV, hd, window,
                    q_offset, kv_lo, chunk, chunks, scale};
  if (bf16) return dispatch_split<__nv_bfloat16>(a, nq, vec, st);
  return dispatch_split<float>(a, nq, vec, st);
}

// The split path's second launch: rows = B * Sq * H output rows.
extern "C" int repro_flash_combine(const void* pm, const void* pl,
                                   const void* pacc, void* out, int rows,
                                   int hd, int chunks, int bf16,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0 || hd == 0) return static_cast<int>(cudaGetLastError());
  const float* m = static_cast<const float*>(pm);
  const float* l = static_cast<const float*>(pl);
  const float* a = static_cast<const float*>(pacc);
  if (bf16)
    combine_kernel<__nv_bfloat16><<<rows, kCombineThreads, 0, st>>>(
        m, l, a, static_cast<__nv_bfloat16*>(out), hd, chunks);
  else
    combine_kernel<float><<<rows, kCombineThreads, 0, st>>>(
        m, l, a, static_cast<float*>(out), hd, chunks);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local (spilled) bytes a thread of body `which`, in the
// order of kernels/flash_attention.py BODIES: the tile bodies (bf16, then
// float32; hd 32, 64, 128, 256), the split bodies (bf16, then float32; by
// hd, then nq 1, 2, 4, 8 and the element-wise 8), the combine (bf16,
// float32).
extern "C" int repro_flash_attrs(int which, int* regs, int* local_bytes) {
  static const void* const bodies[] = {
      REPRO_TILE_BODIES(__nv_bfloat16),
      REPRO_TILE_BODIES(float),
      REPRO_SPLIT_BODIES(__nv_bfloat16),
      REPRO_SPLIT_BODIES(float),
      reinterpret_cast<const void*>(combine_kernel<__nv_bfloat16>),
      reinterpret_cast<const void*>(combine_kernel<float>)};
  constexpr int n = sizeof(bodies) / sizeof(bodies[0]);
  if (which < 0 || which >= n) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, bodies[which]);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
