// Lanes grouped by the row they read, for the backward kernels of the
// gathers (segment_matmul_bwd.cu, embedding_bag_bwd.cu).
//
// A forward gather reads row target(e) of a table for lane e (a lane of a
// neighbour matrix, a lookup of a bag); its gradient sums, for each table
// row r, a term of every lane that read r.  Float atomics would sum those
// terms in an order that changes from run to run and serialise on hot
// rows, so the gradient is a segmented sum instead: the valid lanes are
// sorted by row, stably, so that each row's lanes stand in lane order, and
// one warp (or a group of lanes) a distinct row sums its terms from zero
// in that order.  Every pass costs O(the valid lanes), whatever the
// table's rows R and however skewed the rows are: a hot row (one id in
// every bag) is one run of equal keys.
//   compact_count, compact_write (neighbour matrices only; a bag's lookups
//                  are all valid): one thread a row of M lanes; the valid
//                  lanes' (row, lane) pairs in lane order, each row's
//                  count c_i, the active rows (c_i >= 1) in order and each
//                  row's rank among them; scan_top orders the blocks
//   radix_totals, radix_onesweep: an LSD radix sort of the pairs by row,
//                  digits of at most kRadixBits, as many passes as R - 1
//                  has bits / 8: every pass's digit counts from one read
//                  of the keys, then one launch a pass, whose CTAs take
//                  tiles in order by a ticket and find the counts of the
//                  tiles before them by a decoupled look-back; the
//                  scatter ranks a tile's keys in order (a warp's 32 at
//                  once by __match_any_sync, the warps in order), so each
//                  pass is stable, and writes the tile digit by digit
//                  from shared memory
//   runs_count, scan_top, runs_write: the distinct rows of the sorted
//                  keys and each one's [lo, hi) of sorted lanes
//   group_sum_vec / group_sum_scalar: out[row] = the sum over the row's
//                  lanes e, in order, from 0, of src[term.src(e)], each
//                  term divided first (div_by) or not; the float4 body
//                  gives a group of lanes the rows that start in a block
//                  of sorted positions, 16-byte loads and stores
//   zero_unread:   out's rows that no lane reads, zeros in a store-only
//                  pass, a CTA a span of rows (a bitmap of the span's
//                  distinct rows in shared memory)
// Integer atomics count digits and hand out tickets; no float atomics.
// Counts not known on the host (the valid lanes, the distinct rows, the
// active rows) stay on the card in meta[kMetaInts]: grids are sized by
// their bounds and each kernel reads its count there.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroupThreads = 256;
constexpr int kScanItems = 8;                    // counts a thread a block
constexpr int kScanBlock = kGroupThreads * kScanItems;
constexpr int kSortItems = 8;                    // keys a thread a pass
constexpr int kSortTile = kGroupThreads * kSortItems;   // keys a CTA
constexpr int kWarpKeys = 32 * kSortItems;       // keys a warp, in order
constexpr int kRadixBits = 8;                    // widest digit
constexpr int kRadix = 1 << kRadixBits;
constexpr int kSumWarps = 8;                     // warps a group_sum CTA
constexpr int kSumBatch = 8;                     // row loads in flight
constexpr int kZeroRows = 2048;                  // rows a zero_unread range
constexpr int kZeroMarks = 8;                    // rows read a thread a step
constexpr int kZeroSpan = 128;                   // rows a CTA at least
// meta: the valid lanes, the distinct rows, the active neighbour rows
constexpr int kMetaValid = 0, kMetaDistinct = 1, kMetaActive = 2;
constexpr int kMetaInts = 4;

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}
__device__ __forceinline__ long long grid_start() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// a count: on the card (*dev, written by an earlier launch) or, where dev
// is null, known on the host
struct Count {
  const int* dev;
  long long host;
  __device__ __forceinline__ long long get() const {
    return dev != nullptr ? static_cast<long long>(*dev) : host;
  }
};

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

// ---- the scan -------------------------------------------------------------

// bsum[b nb, (b + 1) nb) -> its exclusive scan, in place, for CTA b (one
// CTA an array, kGroupThreads a round)
__global__ void __launch_bounds__(kGroupThreads)
scan_top(int* __restrict__ bsum, int nb) {
  bsum += static_cast<long long>(blockIdx.x) * nb;
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

// ---- (a) compaction of a neighbour matrix's valid lanes -------------------

// c_i of row i (one thread a row of M lanes): counts[i]; bsum[b] and
// bsum[nb + b] = block b's valid lanes and active rows
template <class Target>
__global__ void __launch_bounds__(kGroupThreads)
compact_count(Target tg, int N, int M, int* __restrict__ counts,
              int* __restrict__ bsum, int nb) {
  const long long i = grid_start();
  int c = 0;
  if (i < N) {
    for (int m = 0; m < M; ++m) c += tg(i * M + m) >= 0;
    counts[i] = c;
  }
  int lanes, active;
  cta_exclusive(c, &lanes);
  cta_exclusive(c > 0, &active);
  if (threadIdx.x == 0) {
    bsum[blockIdx.x] = lanes;
    bsum[nb + blockIdx.x] = active;
  }
}

// the valid lanes' pairs (row, lane) in lane order into keys / vals,
// active[rank] = i for each active row i, rank[i] = that rank or -1; the
// last row writes the totals into meta.  bsum: compact_count's, scanned.
template <class Target>
__global__ void __launch_bounds__(kGroupThreads)
compact_write(Target tg, int N, int M, const int* __restrict__ counts,
              const int* __restrict__ bsum, int nb, int* __restrict__ keys,
              int* __restrict__ vals, int* __restrict__ active,
              int* __restrict__ rank, int* __restrict__ meta) {
  const long long i = grid_start();
  const int c = i < N ? counts[i] : 0;
  int total;
  int at = bsum[blockIdx.x] + cta_exclusive(c, &total);
  const int r = bsum[nb + blockIdx.x] + cta_exclusive(c > 0, &total);
  if (i >= N) return;
  rank[i] = c > 0 ? r : -1;
  if (c > 0) active[r] = static_cast<int>(i);
  for (int m = 0; m < M && c > 0; ++m) {
    const long long e = i * M + m;
    const int key = tg(e);
    if (key < 0) continue;
    keys[at] = key;
    vals[at] = static_cast<int>(e);
    ++at;
  }
  if (i == N - 1) {
    meta[kMetaValid] = at;
    meta[kMetaActive] = r + (c > 0);
  }
}

// ---- (b) the radix sort -------------------------------------------------

// the lanes in order, every one valid: lane e reads row clamp(ids[e], 0,
// R - 1) (a bag's lookups, read from the ids themselves)
struct IdsSrc {
  const int32_t* ids;
  int R;
  __device__ __forceinline__ int key(long long j) const {
    return min(max(__ldg(ids + j), 0), R - 1);
  }
  __device__ __forceinline__ int val(long long j) const {
    return static_cast<int>(j);
  }
};

// the pairs an earlier launch wrote
struct PairSrc {
  const int* keys;
  const int* vals;
  __device__ __forceinline__ int key(long long j) const { return keys[j]; }
  __device__ __forceinline__ int val(long long j) const { return vals[j]; }
};

// The status of tile t's count of digit d in a pass, one 64-bit word:
// the flag in the high half (0: not yet; kAggregate: the tile's own
// count; kInclusive: the count over tiles 0 .. t), the count in the low
// half.  A look-back polls a word at most kSpinLimit times (a fault
// there ends the sort with wrong keys, which the tests see, not a hang).
constexpr unsigned long long kAggregate = 1ULL << 32;
constexpr unsigned long long kInclusive = 2ULL << 32;
constexpr long long kSpinLimit = 1LL << 24;
constexpr int kMaxPasses = 4;                    // 31 bits in 8-bit digits

// totals[p radix + d] += the keys of tile blockIdx.x (kSortTile of them)
// whose digit p, (key >> p bits) & (radix - 1), is d: every pass's digit
// counts from one read of the keys.  The CTAs also zero the passes' tile
// statuses [status_n] and tickets [passes] for radix_onesweep.
template <class Src>
__global__ void __launch_bounds__(kGroupThreads)
radix_totals(Src src, Count count, int bits, int passes,
             int* __restrict__ totals, unsigned long long* __restrict__ status,
             long long status_n, int* __restrict__ tickets) {
  __shared__ int h[kMaxPasses * kRadix];
  const int radix = 1 << bits;
  for (int x = threadIdx.x; x < passes * radix; x += kGroupThreads) h[x] = 0;
  for (long long x = grid_start(); x < status_n; x += grid_stride())
    status[x] = 0;
  if (blockIdx.x == 0 && threadIdx.x < passes) tickets[threadIdx.x] = 0;
  __syncthreads();
  const long long n = count.get();
  const long long t0 = static_cast<long long>(blockIdx.x) * kSortTile;
#pragma unroll
  for (int u = 0; u < kSortItems; ++u) {
    const long long j = t0 + u * kGroupThreads + threadIdx.x;
    if (j >= n) continue;
    const int key = src.key(j);
    for (int p = 0; p < passes; ++p)
      atomicAdd(&h[p * radix + ((key >> (p * bits)) & (radix - 1))], 1);
  }
  __syncthreads();
  for (int x = threadIdx.x; x < passes * radix; x += kGroupThreads)
    if (h[x] != 0) atomicAdd(totals + x, h[x]);
}

// One stable pass, in one launch.  A CTA takes the next tile by a ticket
// (so every tile before it has started), counts its keys' digits, posts
// each count (kAggregate), adds up the counts of the tiles before it
// (looking back until a tile that posted its inclusive count), and posts
// its own inclusive count; key j then goes to (the keys of smaller digits:
// a scan of totals) + (digit d's keys in earlier tiles) + its rank among
// the tile's keys of digit d before it.  Warp w holds the tile's keys
// [w kWarpKeys, (w + 1) kWarpKeys) in rounds of 32 consecutive ones; a
// round's equal digits are found by __match_any_sync and ranked by lane,
// after the warp's earlier rounds (wc[w][d]), and the warps' counts are
// then scanned in warp order, so the tile keeps its order within a digit.
// The tile is sorted by digit in shared memory, then written out in that
// order, so consecutive threads store a digit's consecutive keys.
template <class Src>
__global__ void __launch_bounds__(kGroupThreads)
radix_onesweep(Src src, Count count, int shift, int bits,
               const int* __restrict__ totals,
               unsigned long long* __restrict__ status,
               int* __restrict__ ticket, int* __restrict__ okeys,
               int* __restrict__ ovals) {
  static_assert(kGroupThreads == kRadix, "a digit a thread");
  __shared__ int wc[kGroupThreads / 32][kRadix];
  __shared__ int gpos[kRadix];
  __shared__ int sk[kSortTile];
  __shared__ int sv[kSortTile];
  __shared__ int tile_s;
  const int radix = 1 << bits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_s = atomicAdd(ticket, 1);
  for (int x = threadIdx.x; x < (kGroupThreads / 32) * kRadix;
       x += kGroupThreads)
    (&wc[0][0])[x] = 0;
  __syncthreads();
  const long long t = tile_s;
  const long long n = count.get();
  const long long t0 = t * kSortTile;
  if (t0 >= n) return;
  const unsigned below = (1u << lane) - 1;
  int key[kSortItems], val[kSortItems], dig[kSortItems], rank[kSortItems];
#pragma unroll
  for (int u = 0; u < kSortItems; ++u) {
    const long long j = t0 + warp * kWarpKeys + u * 32 + lane;
    const bool ok = j < n;
    key[u] = ok ? src.key(j) : 0;
    val[u] = ok ? src.val(j) : 0;
    dig[u] = ok ? (key[u] >> shift) & (radix - 1) : kRadix;   // none
    const unsigned peers = __match_any_sync(0xffffffffu, dig[u]);
    const int base = ok ? wc[warp][dig[u]] : 0;
    rank[u] = base + __popc(peers & below);
    __syncwarp();
    if (ok && (peers & below) == 0) wc[warp][dig[u]] = base + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // digit d (thread d): the tile's count, posted; the earlier tiles'
  // counts, looked back; its first place in the sorted tile (a scan over
  // the digits), each warp's after the warps before it, and where the
  // tile's keys of digit d start in the output
  const int d = threadIdx.x;
  int cnt = 0;
  long long before = 0;
  if (d < radix) {
#pragma unroll
    for (int w = 0; w < kGroupThreads / 32; ++w) cnt += wc[w][d];
    volatile unsigned long long* mine = status + t * radix + d;
    *mine = kAggregate | static_cast<unsigned>(cnt);
    long long spins = 0;
    for (long long j = t - 1; j >= 0;) {
      const unsigned long long v =
          *reinterpret_cast<volatile unsigned long long*>(status + j * radix +
                                                          d);
      if (v < kAggregate) {
        if (++spins > kSpinLimit) break;
        continue;
      }
      before += v & 0xffffffffULL;
      if (v >= kInclusive) break;
      --j;
    }
    *mine = kInclusive | static_cast<unsigned>(before + cnt);
  }
  int total;
  const int first = cta_exclusive(cnt, &total);
  const int smaller = cta_exclusive(d < radix ? totals[d] : 0, &total);
  if (d < radix) {
    int run = first;
#pragma unroll
    for (int w = 0; w < kGroupThreads / 32; ++w) {
      const int c = wc[w][d];
      wc[w][d] = run;
      run += c;
    }
    gpos[d] = smaller + static_cast<int>(before) - first;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kSortItems; ++u) {
    if (dig[u] == kRadix) continue;
    const int at = wc[warp][dig[u]] + rank[u];
    sk[at] = key[u];
    sv[at] = val[u];
  }
  __syncthreads();
  const int nt = static_cast<int>(n - t0 < kSortTile ? n - t0 : kSortTile);
  for (int x = threadIdx.x; x < nt; x += kGroupThreads) {
    const int k = sk[x];
    const int at = gpos[(k >> shift) & (radix - 1)] + x;
    okeys[at] = k;
    ovals[at] = sv[x];
  }
}

// bits of the largest row R - 1 (0 for R = 1); passes of at most
// kRadixBits each; the digit's width, spread evenly over the passes
inline int key_bits(long long R) {
  int b = 0;
  while ((1LL << b) < R) ++b;
  return b;
}
inline int sort_passes(long long R) {
  const int b = key_bits(R);
  return b <= kRadixBits ? 1 : (b + kRadixBits - 1) / kRadixBits;
}
inline int digit_bits(long long R) {
  const int b = key_bits(R), p = sort_passes(R);
  return b == 0 ? 1 : (b + p - 1) / p;
}
inline int sort_tiles(long long L) {
  return static_cast<int>(L < 1 ? 1 : (L + kSortTile - 1) / kSortTile);
}
// the buffer (0: X, 1: Y) pass p writes; the last pass writes Y
inline int pass_buffer(int p, int passes) { return (passes - 1 - p) % 2 == 0; }

// ---- (c) the runs -------------------------------------------------------

// the run starts among positions [base, base + kScanItems) of keys [n]: a
// bit each, and their number
__device__ __forceinline__ int run_starts(const int* __restrict__ keys,
                                          long long n, long long base,
                                          unsigned* bits) {
  int prev = base > 0 && base - 1 < n ? keys[base - 1] : -1;
  int s = 0;
  *bits = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (base + k >= n) break;
    const int cur = keys[base + k];
    if (cur != prev) {
      *bits |= 1u << k;
      ++s;
    }
    prev = cur;
  }
  return s;
}

__global__ void __launch_bounds__(kGroupThreads)
runs_count(const int* __restrict__ keys, Count count, int* __restrict__ bsum) {
  const long long base = static_cast<long long>(blockIdx.x) * kScanBlock +
                         static_cast<long long>(threadIdx.x) * kScanItems;
  unsigned bits;
  const int s = run_starts(keys, count.get(), base, &bits);
  int total;
  cta_exclusive(s, &total);
  if (threadIdx.x == 0) bsum[blockIdx.x] = total;
}

// rows[k] = the k-th distinct key, starts[k] = its first position,
// starts[distinct] = n; firsts[p / kScanItems] = the distinct row that
// holds position p, for each p a multiple of kScanItems;
// meta[kMetaDistinct] = distinct (and meta[kMetaValid] = n where the count
// is the host's)
__global__ void __launch_bounds__(kGroupThreads)
runs_write(const int* __restrict__ keys, Count count,
           const int* __restrict__ bsum, int* __restrict__ rows,
           int* __restrict__ starts, int* __restrict__ firsts,
           int* __restrict__ meta) {
  const long long n = count.get();
  const long long block0 = static_cast<long long>(blockIdx.x) * kScanBlock;
  if (n == 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      starts[0] = 0;
      meta[kMetaDistinct] = 0;
      if (count.dev == nullptr) meta[kMetaValid] = 0;
    }
    return;
  }
  if (block0 >= n) return;
  const long long base = block0 + static_cast<long long>(threadIdx.x) *
                                      kScanItems;
  unsigned bits;
  const int s = run_starts(keys, n, base, &bits);
  int total;
  int k = bsum[blockIdx.x] + cta_exclusive(s, &total);
  if (base < n) firsts[base / kScanItems] = (bits & 1u) ? k : k - 1;
#pragma unroll
  for (int x = 0; x < kScanItems; ++x) {
    if (bits >> x & 1u) {
      rows[k] = keys[base + x];
      starts[k] = static_cast<int>(base + x);
      ++k;
    }
  }
  if (base <= n - 1 && n - 1 < base + kScanItems) {
    starts[k] = static_cast<int>(n);
    meta[kMetaDistinct] = k;
    if (count.dev == nullptr) meta[kMetaValid] = static_cast<int>(n);
  }
}

// ---- the grouping: (a)'s pairs or a bag's ids, sorted, then the runs -------

// the sort's scratch for at most L lanes over R rows, in ints: X's keys
// and values, Y's keys, then (8-byte aligned) the passes' tile statuses,
// the digit totals, the tickets and the runs' block sums
inline long long status_words(long long L, long long R) {
  return static_cast<long long>(sort_passes(R)) * sort_tiles(L) *
         (1LL << digit_bits(R));
}
inline long long sort_scratch(long long L, long long R) {
  const long long passes = sort_passes(R), radix = 1LL << digit_bits(R);
  return 3 * (L + 1) + 1 + 2 * status_words(L, R) + passes * radix + passes +
         sort_tiles(L);
}

// The sorted lanes into lanes [L] (Y's values; Y's keys are scratch), the
// distinct rows into rows [L], their starts into starts [L + 1], the row
// of every kScanItems-th position into firsts [ceil(L / kScanItems)], the
// count of distinct rows into meta.  src0: the first pass's input (IdsSrc,
// or PairSrc over the buffer pass 0 does not write: X's when
// pass_buffer(0, passes) is Y, else Y's); n: the valid lanes, at most L.
// Launches: a memset and radix_totals, one radix_onesweep a pass, then
// runs_count, scan_top and runs_write.
template <class Src0>
cudaError_t group_sort(Src0 src0, Count n, long long L, long long R,
                       int* scratch, int* lanes, int* rows, int* starts,
                       int* firsts, int* meta, cudaStream_t st) {
  const int tiles = sort_tiles(L), passes = sort_passes(R);
  const int bits = digit_bits(R), radix = 1 << bits;
  int* kx = scratch;
  int* vx = kx + (L + 1);
  int* ky = vx + (L + 1);
  const long long at = (3 * (L + 1) + 1) & ~1LL;
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(scratch + at);
  const long long words = status_words(L, R);
  int* totals = scratch + at + 2 * words;
  int* tickets = totals + passes * radix;
  int* tbsum = tickets + passes;
  int* dk[2] = {kx, ky};
  int* dv[2] = {vx, lanes};
  cudaError_t e = cudaMemsetAsync(totals, 0, sizeof(int) * passes * radix,
                                  st);
  if (e != cudaSuccess) return e;
  radix_totals<<<tiles, kGroupThreads, 0, st>>>(src0, n, bits, passes,
                                                totals, status, words,
                                                tickets);
  const int* pk = nullptr;
  const int* pv = nullptr;
  for (int p = 0; p < passes; ++p) {
    const int b = pass_buffer(p, passes);
    const long long ps = static_cast<long long>(p) * tiles * radix;
    if (p == 0) {
      radix_onesweep<<<tiles, kGroupThreads, 0, st>>>(
          src0, n, 0, bits, totals, status, tickets, dk[b], dv[b]);
    } else {
      radix_onesweep<<<tiles, kGroupThreads, 0, st>>>(
          PairSrc{pk, pv}, n, p * bits, bits, totals + p * radix,
          status + ps, tickets + p, dk[b], dv[b]);
    }
    pk = dk[b];
    pv = dv[b];
  }
  runs_count<<<tiles, kGroupThreads, 0, st>>>(pk, n, tbsum);
  scan_top<<<1, kGroupThreads, 0, st>>>(tbsum, tiles);
  runs_write<<<tiles, kGroupThreads, 0, st>>>(pk, n, tbsum, rows, starts,
                                              firsts, meta);
  return cudaGetLastError();
}

// ---- (d) the segmented sum over the distinct rows -------------------------

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

__device__ __forceinline__ float term_of(float x, bool divide, double r) {
  return divide ? div_by(x, r) : x;
}

// A Term maps a sorted lane e to src's row (src(e)) and, for a sum that
// divides, its divisor (div_of(e), an integer >= 1).

// out[rows[k]][c] = the sum over positions [starts[k], starts[k + 1]) of
// lanes, in order, from 0, of term(src[term.src(e)][c]) (src [., C] and
// out float32, C % 4 == 0, both 16-byte aligned).  The sorted positions
// are cut into blocks of G (firsts gives the row of each block's first
// position); a group of G lanes (32 / G groups a warp) takes the rows that
// start in its block, at most G, and walks their positions to the last
// one's end, a float4 of columns a lane, G float4 a pass.  It loads those
// rows' bounds at once (one a lane), then their positions G at a time
// (each lane one position's source row, divisor and, where the position
// ends a row, that row), then kSumBatch rows of src in flight before their
// adds in order; a row's sum is stored where its last position is added
// and the next starts from 0.  Rows of one lookup each (most of them at
// both paths' shapes) cost a few round trips a block, not a few a row,
// and a hot row holds up only its own warp.  The warp runs as many steps
// as its longest walk, so its shuffles stay whole.
template <int G, class Term>
__global__ void __launch_bounds__(kSumWarps * 32, G == 8 ? 3 : 2)
group_sum_vec(const float* __restrict__ src, const int* __restrict__ lanes,
              const int* __restrict__ rows, const int* __restrict__ starts,
              const int* __restrict__ firsts, Count positions, Count count,
              Term term, int divide, float* __restrict__ out, int C) {
  static_assert(G >= kSumBatch && 32 % G == 0 && G % kScanItems == 0,
                "groups");
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31, q = lane & (G - 1);
  const int gbase = lane & ~(G - 1);
  const unsigned gmask = (G == 32 ? all : ((1u << G) - 1) << gbase);
  const int cq = C / 4;
  const long long np = positions.get(), nd = count.get();
  const long long warps = static_cast<long long>(gridDim.x) * kSumWarps;
  for (long long w0 = (static_cast<long long>(blockIdx.x) * kSumWarps +
                       (threadIdx.x >> 5)) * 32;
       w0 < np; w0 += warps * 32) {
    // the group's block of positions [p0, p0 + G) and the rows starting in
    // it, k0 + q for the lanes q below the group's count
    const long long p0 = w0 + gbase;
    long long k0 = 0;
    if (p0 < np) {
      const int r = firsts[p0 / kScanItems];
      k0 = r + (starts[r] < p0);
    }
    const long long k = k0 + q;
    const bool has = p0 < np && k < nd && starts[k] < p0 + G;
    const int rows_here = __popc(__ballot_sync(all, has) & gmask);
    const int my_start = has ? starts[k] : 0;
    const int my_row = has ? rows[k] : 0;
    const int hi = rows_here > 0 ? starts[k0 + rows_here] : 0;
    const int lo = __shfl_sync(all, my_start, gbase);
    const int next = __shfl_sync(all, my_start, gbase + ((q + 1) & (G - 1)));
    // the position after row k's last, or -1 for no row
    const int my_end = !has ? -1 : (q + 1 < rows_here ? next : hi);
    const int n = hi - lo;
    const int nmax = __reduce_max_sync(all, n);
    for (int c0 = 0; c0 < cq; c0 += G) {
      const int c4 = c0 + q;
      const bool col = c4 < cq;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      // each step's lane ids are loaded a step ahead
      int e_next = q < n ? lanes[lo + q] : 0;
      for (int b0 = 0; b0 < nmax; b0 += G) {
        // position lo + b0 + q: its source row, divisor, and the row it
        // ends (-1: none)
        const int p = lo + b0 + q;
        const int e = e_next;
        if (b0 + G + q < n) e_next = lanes[p + G];
        int my = 0, my_div = 1, ends = -1;
        if (b0 + q < n) {
          my = term.src(e);
          if (divide) my_div = term.div_of(e);
        }
#pragma unroll 8
        for (int j = 0; j < G; ++j) {
          const int end_j = __shfl_sync(all, my_end, gbase + j);
          const int row_j = __shfl_sync(all, my_row, gbase + j);
          if (end_j == p + 1 && b0 + q < n) ends = row_j;
        }
        const int m = min(G, nmax - b0);
        for (int x = 0; x < m; x += kSumBatch) {
          float4 val[kSumBatch];
#pragma unroll
          for (int u = 0; u < kSumBatch; ++u) {
            const int s = __shfl_sync(all, my, gbase + ((x + u) & (G - 1)));
            val[u] = b0 + x + u < n && col
                         ? __ldg(reinterpret_cast<const float4*>(
                               src + static_cast<long long>(s) * C) + c4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < kSumBatch; ++u) {
            const int from = gbase + ((x + u) & (G - 1));
            const int dv = __shfl_sync(all, my_div, from);
            const int orow = __shfl_sync(all, ends, from);
            if (b0 + x + u < n) {
              const double r = divide ? recip(dv) : 1.0;
              acc.x += term_of(val[u].x, divide, r);
              acc.y += term_of(val[u].y, divide, r);
              acc.z += term_of(val[u].z, divide, r);
              acc.w += term_of(val[u].w, divide, r);
              if (orow >= 0) {
                if (col)
                  reinterpret_cast<float4*>(
                      out + static_cast<long long>(orow) * C)[c4] = acc;
                acc = make_float4(0.f, 0.f, 0.f, 0.f);
              }
            }
          }
        }
      }
    }
  }
}

// The same sum for any C and alignment: a warp a distinct row, a column a
// lane, 32 columns a pass; the row's lanes loaded 32 at once (one a lane)
// and kSumBatch rows of src in flight before their adds.
template <class Term>
__global__ void __launch_bounds__(kSumWarps * 32)
group_sum_scalar(const float* __restrict__ src, const int* __restrict__ lanes,
                 const int* __restrict__ rows, const int* __restrict__ starts,
                 Count count, Term term, int divide, float* __restrict__ out,
                 int C) {
  const int lane = threadIdx.x & 31;
  const long long nd = count.get();
  const long long warps = static_cast<long long>(gridDim.x) * kSumWarps;
  for (long long k = static_cast<long long>(blockIdx.x) * kSumWarps +
                     (threadIdx.x >> 5);
       k < nd; k += warps) {
    const int lo = starts[k], hi = starts[k + 1];
    const long long row = rows[k];
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      float acc = 0.f;
      for (int b0 = lo; b0 < hi; b0 += 32) {
        const int n = min(32, hi - b0);
        int my = 0;
        double my_r = 1.0;
        if (lane < n) {
          const int e = lanes[b0 + lane];
          my = term.src(e);
          if (divide) my_r = recip(term.div_of(e));
        }
        for (int x = 0; x < n; x += kSumBatch) {
          float val[kSumBatch];
          double rr[kSumBatch];
#pragma unroll
          for (int u = 0; u < kSumBatch; ++u) {
            const int s = __shfl_sync(0xffffffffu, my, (x + u) & 31);
            rr[u] = __shfl_sync(0xffffffffu, my_r, (x + u) & 31);
            val[u] = x + u < n && c < C
                         ? src[static_cast<long long>(s) * C + c]
                         : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kSumBatch; ++u) {
            if (x + u >= n) break;
            acc += term_of(val[u], divide, rr[u]);
          }
        }
      }
      if (c < C) out[row * C + c] = acc;
    }
  }
}

// ---- (e) the zeros --------------------------------------------------------

// the first position of rows [n] (ascending) holding a value >= a, by a
// whole warp: 32 probes a step cut the range 33 ways
__device__ __forceinline__ long long lower_bound_warp(
    const int* __restrict__ rows, long long n, long long a) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long p = lo + (hi - lo) * (lane + 1) / 33;
    const unsigned less = __ballot_sync(0xffffffffu, rows[p] < a);
    const int c = __popc(less);
    const long long last = __shfl_sync(0xffffffffu, p, c > 0 ? c - 1 : 0);
    const long long first = __shfl_sync(0xffffffffu, p, c < 32 ? c : 31);
    if (c > 0) lo = last + 1;
    if (c < 32) hi = first;
  }
  return lo;
}

// out [R, C] float32: zeros in every row that rows [count] (ascending)
// does not hold.  A CTA a span of `span` rows, kZeroRows at a time: the
// span's distinct rows (a run of rows from one search) marked in a
// shared bitmap, then the other rows' pieces stored, a float4 each (VEC:
// C % 4 == 0, out 16-byte aligned) or a float, consecutive threads on
// consecutive pieces.
template <bool VEC>
__global__ void __launch_bounds__(kGroupThreads)
zero_unread(const int* __restrict__ rows, Count count,
            float* __restrict__ out, long long R, int C, long long span) {
  __shared__ unsigned mark[kZeroRows / 32];
  __shared__ long long first;
  const long long a0 = static_cast<long long>(blockIdx.x) * span;
  const long long a1 = min(R, a0 + span);
  if (a0 >= a1) return;
  const long long nd = count.get();
  if (threadIdx.x < 32) {
    const long long k = lower_bound_warp(rows, nd, a0);
    if (threadIdx.x == 0) first = k;
  }
  __syncthreads();
  long long k = first;
  const int cq = VEC ? C / 4 : C;
  const int step_r = kGroupThreads / cq, step_c = kGroupThreads % cq;
  for (long long a = a0; a < a1; a += kZeroRows) {
    const int nr = static_cast<int>(min(static_cast<long long>(kZeroRows),
                                        a1 - a));
    for (int w = threadIdx.x; w < kZeroRows / 32; w += kGroupThreads)
      mark[w] = 0;
    __syncthreads();
    // the range's distinct rows, kZeroMarks of them a thread in flight:
    // those below a + nr are a prefix of rows[k, ...)
    for (;;) {
      int mine = 0;
#pragma unroll
      for (int i = 0; i < kZeroMarks; ++i) {
        const long long j = k + i * kGroupThreads + threadIdx.x;
        const int v = j < nd ? rows[j] : -1;
        if (v >= 0 && v < a + nr) {
          const int r = static_cast<int>(v - a);
          atomicOr(&mark[r >> 5], 1u << (r & 31));
          ++mine;
        }
      }
      int got;
      cta_exclusive(mine, &got);
      k += got;
      if (got < kZeroMarks * kGroupThreads) break;
    }
    const long long pieces = static_cast<long long>(nr) * cq;
    int r = threadIdx.x / cq, c = threadIdx.x % cq;
    for (long long x = threadIdx.x; x < pieces; x += kGroupThreads) {
      if (!(mark[r >> 5] >> (r & 31) & 1u)) {
        // streaming stores: the zeros are not read again here
        if constexpr (VEC) {
          __stcs(reinterpret_cast<float4*>(out + (a + r) * C) + c,
                 make_float4(0.f, 0.f, 0.f, 0.f));
        } else {
          __stcs(out + (a + r) * C + c, 0.f);
        }
      }
      c += step_c;
      r += step_r;
      if (c >= cq) {
        c -= cq;
        ++r;
      }
    }
    __syncthreads();   // mark free for the next range
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

// out [R, C] from src over group_sort's outputs for at most L lanes: the
// sum over the distinct rows (their count and the lanes' in meta), then
// the zeros of the rest; the float4 body where C % 4 == 0 and src and out
// are 16-byte aligned (G = 8 lanes a row up to C = 32, else 32), else the
// scalar one
template <class Term>
cudaError_t group_sum(const float* src, const int* lanes, const int* rows,
                      const int* starts, const int* firsts, const int* meta,
                      long long L, Term term, bool divide, float* out,
                      long long R, int C, cudaStream_t st) {
  if (R == 0 || C == 0) return cudaGetLastError();
  const Count nd{meta + kMetaDistinct, 0};
  const Count np{meta + kMetaValid, 0};
  const bool vec = C % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (L > 0) {
    // a warp takes 32 positions a step in the float4 body, a row in the
    // scalar one
    const unsigned pos32 = stride_blocks((L + 31) / 32, kSumWarps);
    if (vec && C <= 32) {
      group_sum_vec<8, Term><<<pos32, kSumWarps * 32, 0, st>>>(
          src, lanes, rows, starts, firsts, np, nd, term, divide, out, C);
    } else if (vec) {
      group_sum_vec<32, Term><<<pos32, kSumWarps * 32, 0, st>>>(
          src, lanes, rows, starts, firsts, np, nd, term, divide, out, C);
    } else {
      group_sum_scalar<Term><<<stride_blocks(L < R ? L : R, kSumWarps),
                               kSumWarps * 32, 0, st>>>(
          src, lanes, rows, starts, nd, term, divide, out, C);
    }
  }
  // a CTA at least kZeroSpan rows, at most kMaxBlocks / 2 CTAs
  const long long blocks0 = (R + kZeroSpan - 1) / kZeroSpan;
  const long long blocks = blocks0 < kMaxBlocks / 2 ? blocks0 : kMaxBlocks / 2;
  const long long span = (R + blocks - 1) / blocks;
  const unsigned zb = static_cast<unsigned>(blocks);
  if (C % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    zero_unread<true><<<zb, kGroupThreads, 0, st>>>(rows, nd, out, R, C,
                                                    span);
  } else {
    zero_unread<false><<<zb, kGroupThreads, 0, st>>>(rows, nd, out, R, C,
                                                     span);
  }
  return cudaGetLastError();
}

}  // namespace
