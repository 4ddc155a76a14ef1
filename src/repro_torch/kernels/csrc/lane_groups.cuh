// Lanes grouped by the row they read, for the backward kernels of the
// gathers (segment_matmul_bwd.cu, embedding_bag_bwd.cu).
//
// A forward gather reads row target(e) of a table for lane e (a lane of a
// neighbour matrix, a lookup of a bag); its gradient sums, for each table
// row r, a term of every lane that read r.  Float atomics would sum those
// terms in an order that changes from run to run and serialise on hot
// rows, so the gradient is a segmented sum instead: the lanes are grouped
// by row with a counting sort built here, each group in lane order, and
// one warp a row sums its group (group_sum) from zero in that order.  The
// grouping is deterministic although its fill uses integer atomics: the
// fill places a group's lanes in any order, and the sort that follows puts
// each at its rank among its group's lane ids.  A hot row (a padding id
// in every bag) is one long group: the sort is O(L log L) in all.
//   group_count:     cnt[target(e)] += 1 (integer atomics)
//   scan_block_sums, scan_top, scan_down: off = exclusive scan of cnt,
//                    off[R] = the lanes kept (three launches, any R)
//   group_fill:      lanes[off[r] + a slot] = e (a slot by an atomic cursor)
//   group_order:     each key ranked in its run of kRun keys of its group
//                    (O(kRun) a key): a group of at most kRun keys is done
//   group_merge:     log2(L / kRun) levels, each merging a longer group's
//                    pairs of runs by binary search; a level with no group
//                    that long returns at once
//   group_sum:       out[r][c] = sum over the group of src[e / div][c],
//                    each term divided by a divisor first (or not)
// A Target maps a lane to its row, or -1 for a lane that reads none.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroupThreads = 256;
constexpr int kScanItems = 8;                    // counts a thread a block
constexpr int kScanBlock = kGroupThreads * kScanItems;
constexpr int kSumWarps = 8;                     // rows a group_sum CTA
constexpr int kSumBatch = 8;                     // row loads in flight
constexpr int kRun = 256;                        // keys a sorted run

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}
__device__ __forceinline__ long long grid_start() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

template <class Target>
__global__ void __launch_bounds__(kGroupThreads)
group_count(Target tg, long long L, int* __restrict__ cnt) {
  for (long long e = grid_start(); e < L; e += grid_stride()) {
    const int r = tg(e);
    if (r >= 0) atomicAdd(cnt + r, 1);
  }
}

// the exclusive prefix of x over the CTA (kGroupThreads threads), and the
// CTA's total in *total
__device__ __forceinline__ int cta_exclusive(int x, int* total) {
  __shared__ int warp_sums[kGroupThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kGroupThreads / 32; ++w) {
    const int s = warp_sums[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();   // warp_sums free for the next call
  *total = all;
  return before + inc - x;
}

// counts [base, base + kScanBlock) of the block, kScanItems consecutive
// ones a thread
__device__ __forceinline__ void load_items(const int* __restrict__ cnt,
                                           long long R, int (&v)[kScanItems]) {
  const long long base = static_cast<long long>(blockIdx.x) * kScanBlock +
                         static_cast<long long>(threadIdx.x) * kScanItems;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k)
    v[k] = base + k < R ? cnt[base + k] : 0;
}

__global__ void __launch_bounds__(kGroupThreads)
scan_block_sums(const int* __restrict__ cnt, long long R,
                int* __restrict__ bsum) {
  int v[kScanItems];
  load_items(cnt, R, v);
  int s = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) s += v[k];
  int total;
  cta_exclusive(s, &total);
  if (threadIdx.x == 0) bsum[blockIdx.x] = total;
}

// bsum[0, nb) -> its exclusive scan, in place (one CTA, kGroupThreads a
// round)
__global__ void __launch_bounds__(kGroupThreads)
scan_top(int* __restrict__ bsum, int nb) {
  int carry = 0;
  for (int b0 = 0; b0 < nb; b0 += kGroupThreads) {
    const int i = b0 + threadIdx.x;
    const int x = i < nb ? bsum[i] : 0;
    int total;
    const int ex = cta_exclusive(x, &total);
    if (i < nb) bsum[i] = carry + ex;
    carry += total;
  }
}

__global__ void __launch_bounds__(kGroupThreads)
scan_down(const int* __restrict__ cnt, long long R,
          const int* __restrict__ bsum, int* __restrict__ off) {
  int v[kScanItems];
  load_items(cnt, R, v);
  int s = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) s += v[k];
  int total;
  int run = bsum[blockIdx.x] + cta_exclusive(s, &total);
  const long long base = static_cast<long long>(blockIdx.x) * kScanBlock +
                         static_cast<long long>(threadIdx.x) * kScanItems;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (base + k < R) off[base + k] = run;
    run += v[k];
    if (base + k == R - 1) off[R] = run;
  }
}

template <class Target>
__global__ void __launch_bounds__(kGroupThreads)
group_fill(Target tg, long long L, const int* __restrict__ off,
           int* __restrict__ cursor, int* __restrict__ keys) {
  for (long long e = grid_start(); e < L; e += grid_stride()) {
    const int r = tg(e);
    if (r >= 0) keys[off[r] + atomicAdd(cursor + r, 1)] = static_cast<int>(e);
  }
}

// A group's keys sorted in runs of kRun: each key ranked among its run
// by a scan of the run (O(kRun) a key); a group of at most kRun keys is
// then final, a longer one is merged level by level (group_merge).  grp
// [slot] = the slot's group; *maxk = the longest group above kRun.
template <class Target>
__global__ void __launch_bounds__(kGroupThreads)
group_order(Target tg, long long R, const int* __restrict__ off,
            const int* __restrict__ unordered, int* __restrict__ runs,
            int* __restrict__ keys, int* __restrict__ grp,
            int* __restrict__ maxk) {
  const long long n = off[R];
  for (long long s = grid_start(); s < n; s += grid_stride()) {
    const int key = unordered[s];
    const int r = tg(key);
    const int lo = off[r], hi = off[r + 1];
    const int a = lo + (static_cast<int>(s) - lo) / kRun * kRun;
    const int b = min(a + kRun, hi);
    int rank = 0;
    for (int x = a; x < b; ++x) rank += unordered[x] < key;
    grp[s] = r;
    if (hi - lo <= kRun) {
      keys[a + rank] = key;
    } else {
      runs[a + rank] = key;
      if (s == lo) atomicMax(maxk, hi - lo);
    }
  }
}

// One merge level of the groups longer than `width`: pairs of sorted runs
// of `width` keys into runs of 2 width, each key placed at its index in
// its run plus its rank in the other run (a binary search: the keys of a
// group are distinct); a group whose runs become one goes to keys.
__global__ void __launch_bounds__(kGroupThreads)
group_merge(long long R, int width, const int* __restrict__ off,
            const int* __restrict__ grp, const int* __restrict__ maxk,
            const int* __restrict__ src, int* __restrict__ dst,
            int* __restrict__ keys) {
  if (width >= *maxk) return;
  const long long n = off[R];
  for (long long s = grid_start(); s < n; s += grid_stride()) {
    const int r = grp[s];
    const int lo = off[r], hi = off[r + 1];
    if (hi - lo <= width) continue;
    const int key = src[s];
    const int j = (static_cast<int>(s) - lo) / width, p = j ^ 1;
    int x = lo + p * width, y = min(x + width, hi);
    const int own = static_cast<int>(s) - (lo + j * width);
    int below = 0;
    if (x < hi) {
      const int first = x;
      while (x < y) {
        const int mid = (x + y) >> 1;
        if (src[mid] < key) x = mid + 1; else y = mid;
      }
      below = x - first;
    }
    const int at = lo + min(j, p) * width + own + below;
    (hi - lo <= 2LL * width ? keys : dst)[at] = key;
  }
}

// 1 / k in float64 for an integer k >= 1, without a division (whose
// slow path is a call that takes a stack frame): the fast float
// reciprocal, then two Newton steps (1e-7 -> 1e-14 -> float64's rounding)
__device__ __forceinline__ double recip(int k) {
  const double kd = k;
  double r = __fdividef(1.f, static_cast<float>(k));
  r = r * (2.0 - kd * r);
  return r * (2.0 - kd * r);
}

// x / k rounded to float32 as a division rounds it, from r = recip(k):
// the float64 product is within 2^-52 of x / k, and for k < 2^24 a
// quotient that is not a float32 midpoint lies at least 2^-49 from one
// (its distance is a nonzero multiple of the midpoint's last bit over
// k), so the rounding is the division's; an exact midpoint arises only
// for a subnormal quotient and an even k with an odd factor, where the
// tie may go either way
__device__ __forceinline__ float div_by(float x, double r) {
  return static_cast<float>(static_cast<double>(x) * r);
}

// out[r][c] = sum over the keys e of group r, in order, from 0 of
// src[e / div][c] (src [., C] float32), each term divided first by
// row_div[e / div] (if given) or by const_div (if > 0), rounded to
// nearest (div_by); out [R, C] float32.  One warp a run of 32 rows: the run's
// bounds loaded at once (one row a lane, so most of a table's rows, read
// by no lane, cost one write of zeros), then a row at a time, 32 columns
// a pass; a group's keys loaded 32 at once (one a lane) and kSumBatch
// rows in flight before their adds.
__global__ void __launch_bounds__(kSumWarps * 32)
group_sum(const float* __restrict__ src, const int* __restrict__ keys,
          const int* __restrict__ off, const int* __restrict__ row_div,
          float* __restrict__ out, long long R, int C, int div,
          int const_div) {
  const int lane = threadIdx.x & 31;
  const bool divide = row_div != nullptr || const_div > 0;
  const long long warps = static_cast<long long>(gridDim.x) * kSumWarps;
  for (long long r0 = 32 * (static_cast<long long>(blockIdx.x) * kSumWarps +
                            (threadIdx.x >> 5));
       r0 < R; r0 += 32 * warps) {
    const long long mine = r0 + lane;
    const int my_lo = mine < R ? off[mine] : 0;
    const int my_hi = mine < R ? off[mine + 1] : 0;
    const int rows = static_cast<int>(R - r0 < 32 ? R - r0 : 32);
    for (int j = 0; j < rows; ++j) {
      const long long r = r0 + j;
      const int lo = __shfl_sync(0xffffffffu, my_lo, j);
      const int hi = __shfl_sync(0xffffffffu, my_hi, j);
      for (int c0 = 0; c0 < C; c0 += 32) {
        const int c = c0 + lane;
        float acc = 0.f;
        for (int b0 = lo; b0 < hi; b0 += 32) {
          const int n = min(32, hi - b0);
          const int my = lane < n ? keys[b0 + lane] / div : 0;
          double my_r = 1.0;
          if (lane < n && divide)
            my_r = recip(row_div != nullptr ? row_div[my] : const_div);
          for (int x = 0; x < n; x += kSumBatch) {
            float val[kSumBatch];
            double rr[kSumBatch];
#pragma unroll
            for (int u = 0; u < kSumBatch; ++u) {
              const int row = __shfl_sync(0xffffffffu, my, (x + u) & 31);
              rr[u] = __shfl_sync(0xffffffffu, my_r, (x + u) & 31);
              val[u] = x + u < n && c < C
                           ? src[static_cast<long long>(row) * C + c]
                           : 0.f;
            }
#pragma unroll
            for (int u = 0; u < kSumBatch; ++u) {
              if (x + u >= n) break;
              acc += divide ? div_by(val[u], rr[u]) : val[u];
            }
          }
        }
        if (c < C) out[r * C + c] = acc;
      }
    }
  }
}

// the grid of a grid-stride launch over n items: at most kMaxBlocks, so
// that a pass over 10^7 rows is a few thousand CTAs that loop, not a
// million that the card schedules one by one
constexpr long long kMaxBlocks = 132 * 16;
inline unsigned stride_blocks(long long n, int threads) {
  const long long b = (n + threads - 1) / threads;
  return static_cast<unsigned>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}
// group_sum's grid for R rows (a warp a run of 32 rows, looping)
inline unsigned sum_blocks(long long R) {
  return stride_blocks((R + 31) / 32, kSumWarps);
}

// off [R + 1] = the exclusive scan of cnt [R], bsum [scan_blocks(R)] its
// scratch: three launches
inline int scan_blocks(long long R) {
  return static_cast<int>((R + kScanBlock - 1) / kScanBlock);
}
inline cudaError_t exclusive_scan(const int* cnt, long long R, int* bsum,
                                  int* off, cudaStream_t st) {
  const int nb = scan_blocks(R);
  if (nb == 0) return cudaMemsetAsync(off, 0, sizeof(int), st);
  scan_block_sums<<<nb, kGroupThreads, 0, st>>>(cnt, R, bsum);
  scan_top<<<1, kGroupThreads, 0, st>>>(bsum, nb);
  scan_down<<<nb, kGroupThreads, 0, st>>>(cnt, R, bsum, off);
  return cudaGetLastError();
}

// ints of lane scratch group_lanes takes for L lanes
inline long long lane_scratch(long long L) { return 4 * L + 1; }

// the grouping: cnt and cursor [R] are scratch (zeroed here), off [R + 1],
// bsum [scan_blocks(R)], lanes [lane_scratch(L)] (the fill, two buffers
// of runs, each slot's group, the longest group); the ordered keys [L]
// into keys
template <class Target>
cudaError_t group_lanes(Target tg, long long L, long long R, int* cnt,
                        int* cursor, int* off, int* bsum, int* lanes,
                        int* keys, cudaStream_t st) {
  int* unordered = lanes;
  int* runs = lanes + L;
  int* grp = lanes + 2 * L;
  int* other = lanes + 3 * L;
  int* maxk = lanes + 4 * L;
  cudaError_t e = cudaMemsetAsync(cnt, 0, sizeof(int) * R, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(cursor, 0, sizeof(int) * R, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(maxk, 0, sizeof(int), st);
  if (e != cudaSuccess) return e;
  const unsigned gl = stride_blocks(L, kGroupThreads);
  if (L > 0) group_count<<<gl, kGroupThreads, 0, st>>>(tg, L, cnt);
  e = exclusive_scan(cnt, R, bsum, off, st);
  if (e != cudaSuccess || L == 0) return e;
  group_fill<<<gl, kGroupThreads, 0, st>>>(tg, L, off, cursor, unordered);
  group_order<<<gl, kGroupThreads, 0, st>>>(tg, R, off, unordered, runs,
                                            keys, grp, maxk);
  // levels until a run of width keys holds any group of L keys; each
  // returns at once when no group is that long
  int* src = runs;
  int* dst = other;
  for (long long width = kRun; width < L; width *= 2) {
    group_merge<<<gl, kGroupThreads, 0, st>>>(R, static_cast<int>(width),
                                              off, grp, maxk, src, dst,
                                              keys);
    int* t = src;
    src = dst;
    dst = t;
  }
  return cudaGetLastError();
}

}  // namespace
