// Times the visited filter of src/repro_torch/kernels/csrc/visited.cu (one
// round trip for a row's 32 lanes, their order resolved in registers) on
// its bucket-major [B, S, W] table and, with the same algorithm copied
// here onto the reference's way-major [B, W, S] layout, where a probe
// touches 8 sectors: what the algorithm and the layout each bring.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o build/repro_torch_kernels/visited_layout_bench \
//       tools/visited_layout_bench.cu \
//     && build/repro_torch_kernels/visited_layout_bench
//
// The large regime's shape: B = 10,240 rows, S = 2,048 buckets of W = 8,
// M = 32 lanes a call; ids uniform in [0, 2^20), the second half of each
// call repeating the first, 80% valid.  Three calls fill the tables, then
// each layout is timed (CUDA events, the least of 5 means of 20 calls on a
// copy of the filled table) in the order bucket-major, way-major,
// way-major, bucket-major, after checking that both layouts give the same
// sets and the same fresh lanes.
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

#include "../src/repro_torch/kernels/csrc/visited.cu"

namespace {

constexpr int kB = 10240, kS = 2048, kW = 8, kM = 32, kShift = 21;

// visited.cu's visited_filter_kernel<false> with way k of bucket j of a
// row at tab[k * S + j] in place of tab[j * W + k]
__global__ void __launch_bounds__(kThreads)
way_major_filter_kernel(int32_t* table, const int32_t* __restrict__ ids,
                        const uint8_t* __restrict__ valid,
                        uint8_t* __restrict__ fresh, int B, int W, int S,
                        int M, int shift) {
  const long long b =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  const unsigned below = (1u << lane) - 1u;
  int32_t* tab = table + b * static_cast<long long>(S) * W;
  for (int m0 = 0; m0 < M; m0 += 32) {
    const long long l = b * M + m0 + lane;
    const bool in = m0 + lane < M;
    const int32_t lid = in ? ids[l] : 0;
    const bool lval = in && valid[l] != 0;
    const uint32_t bucket =
        (static_cast<uint32_t>(lid) * 0x9E3779B9u) >> shift;
    int32_t w[kMaxWays] = {};
    int32_t* bp = tab + bucket;
    if (lval) {
#pragma unroll
      for (int k = 0; k < kMaxWays; ++k)
        w[k] = k < W ? bp[static_cast<long long>(k) * S] : 0;
    }
    const unsigned grp =
        __match_any_sync(kFull, lval ? bucket : 0x80000000u | lane);
    const unsigned same = __match_any_sync(kFull, lid) & grp;
    const bool first = lval && (same & below) == 0u;
    bool hit = false;
    int n_empty = 0;
#pragma unroll
    for (int k = 0; k < kMaxWays; ++k) {
      hit |= k < W && w[k] == lid;
      n_empty += k < W && w[k] == -1;
    }
    const bool miss = first && !hit;
    const int rank = __popc(__ballot_sync(kFull, miss) & grp & below);
    const bool f = miss && rank < n_empty;
    if (f) {
      int slot = 0;
#pragma unroll
      for (int k = 0, e = 0; k < kMaxWays; ++k) {
        const bool empty = k < W && w[k] == -1;
        if (empty && e == rank) slot = k;
        e += empty;
      }
      bp[static_cast<long long>(slot) * S] = lid;
    }
    if (in) fresh[l] = f ? 1 : 0;
    __syncwarp();
  }
}

void check(cudaError_t e, const char* what) {
  if (e != cudaSuccess) {
    std::fprintf(stderr, "%s: %s\n", what, cudaGetErrorString(e));
    std::exit(1);
  }
}

// one call of the filter on either layout
void run(bool bucket_major, int32_t* tab, const int32_t* ids,
         const uint8_t* valid, uint8_t* fresh) {
  const int blocks = (kB * 32 + kThreads - 1) / kThreads;
  if (bucket_major) {
    check(static_cast<cudaError_t>(repro_visited_filter(
              tab, ids, valid, fresh, kB, kW, kS, kM, kShift, nullptr)),
          "bucket-major launch");
  } else {
    way_major_filter_kernel<<<blocks, kThreads>>>(tab, ids, valid, fresh, kB,
                                                  kW, kS, kM, kShift);
    check(cudaGetLastError(), "way-major launch");
  }
}

float time_ms(bool bucket_major, int32_t* work, const int32_t* filled,
              const int32_t* ids, const uint8_t* valid, uint8_t* fresh,
              size_t tab_bytes) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float best = 1e30f;
  for (int r = 0; r < 5; ++r) {
    check(cudaMemcpy(work, filled, tab_bytes, cudaMemcpyDeviceToDevice),
          "copy");
    run(bucket_major, work, ids, valid, fresh);   // warm-up
    cudaEventRecord(e0);
    for (int i = 0; i < 20; ++i) run(bucket_major, work, ids, valid, fresh);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, e0, e1);
    best = std::min(best, ms / 20);
  }
  return best;
}

}  // namespace

int main() {
  const size_t n_lanes = static_cast<size_t>(kB) * kM;
  const size_t tab_bytes = static_cast<size_t>(kB) * kS * kW * 4;
  std::mt19937 gen(0);
  std::uniform_int_distribution<int32_t> any_id(0, (1 << 20) - 1);
  std::bernoulli_distribution keep(0.8);
  std::vector<int32_t> h_ids(4 * n_lanes);
  std::vector<uint8_t> h_valid(4 * n_lanes);
  for (size_t l = 0; l < h_ids.size(); ++l) {
    const size_t m = l % kM;
    h_ids[l] = m < kM / 2 ? any_id(gen) : h_ids[l - kM / 2];
    h_valid[l] = keep(gen);
  }
  int32_t *ids, *tab[2], *work;
  uint8_t *valid, *fresh[2];
  check(cudaMalloc(&ids, h_ids.size() * 4), "malloc");
  check(cudaMalloc(&valid, h_valid.size()), "malloc");
  check(cudaMalloc(&fresh[0], n_lanes), "malloc");
  check(cudaMalloc(&fresh[1], n_lanes), "malloc");
  for (auto& t : tab) {
    check(cudaMalloc(&t, tab_bytes), "malloc");
    check(cudaMemset(t, 0xff, tab_bytes), "memset");   // EMPTY = -1
  }
  check(cudaMalloc(&work, tab_bytes), "malloc");
  cudaMemcpy(ids, h_ids.data(), h_ids.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(valid, h_valid.data(), h_valid.size(), cudaMemcpyHostToDevice);
  // fill both layouts with three calls, and hold them to each other
  for (int c = 0; c < 3; ++c)
    for (int lay = 0; lay < 2; ++lay)
      run(lay == 0, tab[lay], ids + c * n_lanes, valid + c * n_lanes,
          fresh[lay]);
  check(cudaDeviceSynchronize(), "fill");
  std::vector<int32_t> t0(tab_bytes / 4), t1(tab_bytes / 4);
  std::vector<uint8_t> f0(n_lanes), f1(n_lanes);
  cudaMemcpy(t0.data(), tab[0], tab_bytes, cudaMemcpyDeviceToHost);
  cudaMemcpy(t1.data(), tab[1], tab_bytes, cudaMemcpyDeviceToHost);
  cudaMemcpy(f0.data(), fresh[0], n_lanes, cudaMemcpyDeviceToHost);
  cudaMemcpy(f1.data(), fresh[1], n_lanes, cudaMemcpyDeviceToHost);
  long long differ = f0 != f1;
  for (size_t b = 0; b < static_cast<size_t>(kB); ++b)
    for (size_t j = 0; j < static_cast<size_t>(kS); ++j)
      for (size_t w = 0; w < static_cast<size_t>(kW); ++w)
        differ += t0[(b * kS + j) * kW + w] != t1[(b * kW + w) * kS + j];
  if (differ) {
    std::fprintf(stderr, "layouts disagree on %lld entries\n", differ);
    return 1;
  }
  const int32_t* t_ids = ids + 3 * n_lanes;
  const uint8_t* t_valid = valid + 3 * n_lanes;
  const float a1 = time_ms(true, work, tab[0], t_ids, t_valid, fresh[0],
                           tab_bytes);
  const float b1 = time_ms(false, work, tab[1], t_ids, t_valid, fresh[1],
                           tab_bytes);
  const float b2 = time_ms(false, work, tab[1], t_ids, t_valid, fresh[1],
                           tab_bytes);
  const float a2 = time_ms(true, work, tab[0], t_ids, t_valid, fresh[0],
                           tab_bytes);
  std::printf("{\"shape\": [%d, %d, %d], \"M\": %d, "
              "\"bucket_major_ms\": [%.5f, %.5f], "
              "\"way_major_ms\": [%.5f, %.5f], "
              "\"probe_sector_bytes\": {\"bucket_major\": 32, "
              "\"way_major\": %d}}\n",
              kB, kS, kW, kM, a1, a2, b1, b2, 32 * kW);
  return 0;
}
