// Row-wise (dist, id) bitonic merge for Hopper (sm_90a).
//
// Replaces the reference's TPU kernel kernels/topk.py rank_merge_pallas
// (_bitonic_network, _sort_kernel, _masked_sort_kernel): each row of
// (dists [R, W], ids [R, W]) is sorted ascending by (dist, id), masked
// lanes carry dist 3.4e38 and keep their ids, the width is padded to the
// next power of two Wp with (3.4e38, PAD_ID = 2^31 - 1), and the first
// `keep` lanes are written out.  The compare is the reference's
//   a before b  <=>  a_d < b_d  or  (a_d == b_d and a_i < b_i),
// so -0.0 and +0.0 tie and break on id, as lexsort((ids, dists)) does.
// With a null mask and a power-of-two W the same entry is the reference's
// bitonic_sort_pallas (keep = W) and bitonic_topk_pallas (keep = k), which
// share _bitonic_network with rank_merge_pallas as they share this one.
//
// Bound: memory for the widths on the search path (R * W * 9 bytes in,
// R * keep * 8 out); the network's Wp/2 * log2(Wp) * (log2(Wp) + 1) / 2
// compare-exchanges per row run from shared memory, and at the widest
// rows (16,384 lanes) they take longer than the bytes.  Design: one CTA
// per row, the padded row staged once in shared memory (8 * Wp bytes, up
// to 128 KB at the widest 16,384 lanes, above 48 KB as dynamic shared
// memory), every stage a pass of independent compare-exchanges separated
// by __syncthreads, and only the kept prefix written back.  Wider rows are
// merged in column chunks by the caller (kernels/topk.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.4e38f;
constexpr int32_t kPadId = 2147483647;

__global__ void rank_merge_kernel(const float* __restrict__ dists,
                                  const int32_t* __restrict__ ids,
                                  const uint8_t* __restrict__ mask,
                                  float* __restrict__ od,
                                  int32_t* __restrict__ oi, int W, int Wp,
                                  int keep) {
  extern __shared__ unsigned char smem[];
  float* sd = reinterpret_cast<float*>(smem);
  int32_t* si = reinterpret_cast<int32_t*>(sd + Wp);
  const long long r = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int c = tid; c < Wp; c += nt) {
    if (c < W) {
      const long long l = r * W + c;
      sd[c] = (mask == nullptr || mask[l] != 0) ? dists[l] : kInf;
      si[c] = ids[l];
    } else {
      sd[c] = kInf;
      si[c] = kPadId;
    }
  }
  __syncthreads();
  const int half = Wp >> 1;
  for (int k = 2; k <= Wp; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < half; t += nt) {
        const int a = 2 * j * (t / j) + (t % j);
        const int b = a + j;
        const bool asc = (a & k) == 0;
        const float ad = sd[a], bd = sd[b];
        const int32_t ai = si[a], bi = si[b];
        const bool a_smaller = (ad < bd) || (ad == bd && ai < bi);
        if (a_smaller != asc) {
          sd[a] = bd;
          sd[b] = ad;
          si[a] = bi;
          si[b] = ai;
        }
      }
      __syncthreads();
    }
  }
  for (int c = tid; c < keep; c += nt) {
    od[r * keep + c] = sd[c];
    oi[r * keep + c] = si[c];
  }
}

}  // namespace

extern "C" int repro_rank_merge(const void* dists, const void* ids,
                                const void* mask, void* od, void* oi, int R,
                                int W, int Wp, int keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  int threads = Wp / 2;
  if (threads < 32) threads = 32;
  if (threads > 512) threads = 512;
  const size_t smem = (size_t)Wp * (sizeof(float) + sizeof(int32_t));
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(rank_merge_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  rank_merge_kernel<<<R, threads, smem, st>>>(
      static_cast<const float*>(dists), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(mask), static_cast<float*>(od),
      static_cast<int32_t*>(oi), W, Wp, keep);
  return static_cast<int>(cudaGetLastError());
}
