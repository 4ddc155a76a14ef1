// EmbeddingBag for Hopper (sm_90a).
//
// Replaces the reference's TPU kernel kernels/embedding_bag.py
// embedding_bag_pallas (_bag_kernel): table [V, E] float32 or bf16, ids
// [B, bag] int32 -> out [B, E] in the table's type,
//   out[b] = sum over t = 0 .. bag-1 of table[ids[b, t]]   (sum)
//   out[b] = that sum / bag                                (mean)
// summed in fp32 in the order t = 0, 1, ... from zero, as the reference's
// body does (a bf16 row widened to fp32 first, its .astype(float32)), the
// mean a true division (__fdiv_rn), not a reciprocal multiply, and a bf16
// output rounded once, to nearest even, on the store.  The reference
// leaves ids outside [0, V) undefined; here they are clamped into the
// table, so the kernel never reads outside it.  Row offsets are 64-bit:
// V * E can pass 2^31.
//
// Bound: bytes.  Each lookup moves one row of E elements for E adds.  At
// wide_deep's bag fields (a 10,000,000 x 32 table, bag 10) and its
// training batch of 65,536 that is 84 MB of fp32 rows (42 MB in bf16) and
// 2.6 MB of ids in and 8.4 MB (4.2 MB) out, 0.028 ms (0.014 ms) at
// 3.35 TB/s, against 21 MFLOP.  The rows are random, so the time goes to
// the latency of the row reads, and what counts is how many bytes each SM
// has in flight.
//
// Two bodies, chosen by kernels/embedding_bag.py path() before launch:
//
// "vector" (rows of a multiple of 16 bytes, table and out 16-byte
// aligned).  A row of E * elem bytes is C = E * elem / 16 pieces of 16
// bytes, read with ld.global.nc.v4 and an L1::no_allocate hint (a row is
// read once).  A group of G lanes serves one bag, G the power of two at
// or above C up to 32 (4 lanes for a bf16 row of 32, 8 for fp32), so a
// warp serves 32 / G bags at once; a row wider than 32 pieces is walked
// by the group 32 pieces at a time.  Each lane issues its piece of up to
// kBatch rows before the first add.  The bytes in flight are bounded by
// the registers that hold them: at 64 registers a thread, four CTAs of
// 256 threads an SM keep 256 x 8 x 16 B = 32 KB each in flight, 128 KB an
// SM, where the lane body's 32-register warps keep at most 64 x 10 rows
// of 128 B (fp32) or 64 B (bf16), 80 or 40 KB (8 rows a batch and four
// CTAs measured faster on the card than 16 rows and two, at uniform and
// at skewed ids alike).  The group's lanes load the bag's ids between
// them, each a different id, and hand them round with __shfl_sync.  The
// grid is persistent: the CTAs that fit walk the bag groups with a grid
// stride, and each lane loads its next bag's ids right after issuing the
// current bag's first rows, so the id round trip overlaps the row loads
// instead of preceding them.
//
// "lane" (any row; the route for rows that are not a multiple of 16
// bytes, or operands off 16-byte alignment; the earlier design).  One
// warp a bag, the lanes spanning E: a row of 32 elements is one load
// instruction (128 bytes in fp32, 64 in bf16); a warp loads up to
// kLaneBatch of its bag's ids and then issues all kLaneBatch row loads
// before the first add.
//
// Both bodies add the same widened elements in the same order from the
// same zero and divide and round alike, so they agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;       // the lane body: bags per CTA
constexpr int kLaneBatch = 16;  // ... and its row loads before the adds
constexpr int kThreads = 256;   // the vector body: threads per CTA
constexpr int kBatch = 8;       // ... and a lane's row loads before the adds
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long clamp_row(long long r, long long V) {
  return r < 0 ? 0 : (r >= V ? V - 1 : r);
}

// ---------------------------------------------------------------------
// the lane body
// ---------------------------------------------------------------------

// one element of the table, widened to fp32 (a bf16 element's bits are
// the top half of its float32)
template <typename T>
__device__ __forceinline__ float load_elem(const T* p);
template <>
__device__ __forceinline__ float load_elem<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float load_elem<uint16_t>(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(uint16_t* p, float x) {
  *p = static_cast<uint16_t>(bf16_bits(x));
}

__device__ __forceinline__ float finish(float acc, int bag, int mean) {
  return mean ? __fdiv_rn(acc, static_cast<float>(bag)) : acc;
}

// T: float (fp32 table) or uint16_t (a bf16 table's raw elements)
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
bag_lane_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                T* __restrict__ out, int B, int bag, long long V, int E,
                int mean) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const int32_t* bag_ids = ids + b * bag;
  T* orow = out + b * E;
  for (int c0 = 0; c0 < E; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.f;
    for (int t0 = 0; t0 < bag; t0 += kLaneBatch) {
      float v[kLaneBatch];
#pragma unroll
      for (int u = 0; u < kLaneBatch; ++u) {
        v[u] = 0.f;
        if (t0 + u < bag && c < E) {
          const long long r = clamp_row(__ldg(bag_ids + t0 + u), V);
          v[u] = load_elem(table + r * E + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kLaneBatch; ++u) {
        if (t0 + u < bag) acc += v[u];
      }
    }
    if (c < E) store_elem(orow + c, finish(acc, bag, mean));
  }
}

// ---------------------------------------------------------------------
// the vector body
// ---------------------------------------------------------------------

// 16 bytes of a row that is read once: not kept in L1
__device__ __forceinline__ uint4 load_piece(const uint4* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ void add_piece(float* acc, uint4 v, float) {
  acc[0] += __uint_as_float(v.x);
  acc[1] += __uint_as_float(v.y);
  acc[2] += __uint_as_float(v.z);
  acc[3] += __uint_as_float(v.w);
}

// a word holds two bf16 elements, the lower-addressed one in its low half
__device__ __forceinline__ void add_word(float* acc, uint32_t w) {
  acc[0] += __uint_as_float(w << 16);
  acc[1] += __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void add_piece(float* acc, uint4 v, uint16_t) {
  add_word(acc, v.x);
  add_word(acc + 2, v.y);
  add_word(acc + 4, v.z);
  add_word(acc + 6, v.w);
}

__device__ __forceinline__ uint4 pack_piece(const float* acc, int bag,
                                            int mean, float) {
  return make_uint4(__float_as_uint(finish(acc[0], bag, mean)),
                    __float_as_uint(finish(acc[1], bag, mean)),
                    __float_as_uint(finish(acc[2], bag, mean)),
                    __float_as_uint(finish(acc[3], bag, mean)));
}

__device__ __forceinline__ uint32_t pack_word(const float* acc, int bag,
                                              int mean) {
  return bf16_bits(finish(acc[0], bag, mean)) |
         (bf16_bits(finish(acc[1], bag, mean)) << 16);
}

__device__ __forceinline__ uint4 pack_piece(const float* acc, int bag,
                                            int mean, uint16_t) {
  return make_uint4(pack_word(acc, bag, mean), pack_word(acc + 2, bag, mean),
                    pack_word(acc + 4, bag, mean),
                    pack_word(acc + 6, bag, mean));
}

// The ids t0 + sub + j * G (j < kIds, below t0 + kBatch and bag) of bag b
// into id[j]: a group's lanes hold a batch of ids between them, each
// lane its own.  Lanes past the batch or off the batch of bags hold 0.
template <int G, int kIds>
__device__ __forceinline__ void load_ids(int (&id)[kIds],
                                         const int32_t* __restrict__ ids,
                                         long long b, int B, int bag, int t0,
                                         int sub) {
#pragma unroll
  for (int j = 0; j < kIds; ++j) {
    const int u = sub + j * G;
    const int t = t0 + u;
    id[j] = (b < B && u < kBatch && t < bag) ? __ldg(ids + b * bag + t) : 0;
  }
}

// CTAs an SM a vector body asks registers for: four (64 registers a
// thread) where a lane holds at most 2 ids of a batch; with more ids a
// lane (8 and the next bag's 8 at G = 1, 4 and 4 at G = 2) that many
// registers would spill, so those bodies take fewer
template <int G>
constexpr int vector_ctas() { return G == 1 ? 2 : (G == 2 ? 3 : 4); }

// T: float or uint16_t (bf16); G: lanes a bag (a power of two, 1-32);
// table and out as 16-byte pieces, C pieces a row
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, vector_ctas<G>())
bag_vector_kernel(const uint4* __restrict__ table,
                  const int32_t* __restrict__ ids, uint4* __restrict__ out,
                  int B, int bag, long long V, int C, int mean) {
  constexpr int kPerWarp = 32 / G;              // bags a warp serves at once
  constexpr int kPerCta = kThreads / G;         // ... a CTA
  constexpr int kIds = (kBatch + G - 1) / G;    // ids a lane holds a batch
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));  // a piece
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;                     // the lane's piece of a row
  const long long stride = (long long)gridDim.x * kPerCta;
  // the warp's first bag walks warp-uniformly, so every lane of a warp
  // takes each shuffle; a lane whose bag is past B loads and stores nothing
  long long wb =
      (long long)blockIdx.x * kPerCta + (threadIdx.x >> 5) * kPerWarp;
  long long b = wb + lane / G;
  int nxt[kIds];
  load_ids<G>(nxt, ids, b, B, bag, 0, sub);
  for (; wb < B; wb += stride, b += stride) {
    const bool live = b < B;
    int cur[kIds];
#pragma unroll
    for (int j = 0; j < kIds; ++j) cur[j] = nxt[j];
    for (int c0 = 0; c0 < C; c0 += G) {
      const int c = c0 + sub;
      const bool on = live && c < C;
      float acc[kElems];
#pragma unroll
      for (int e = 0; e < kElems; ++e) acc[e] = 0.f;
      for (int t0 = 0; t0 < bag; t0 += kBatch) {
        // the batch's ids: the first batch of the first piece came ahead
        if (c0 > 0 || t0 > 0) load_ids<G>(cur, ids, b, B, bag, t0, sub);
        uint4 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const long long r =
              clamp_row(__shfl_sync(kFull, cur[u / G], u % G, G), V);
          v[u] = make_uint4(0u, 0u, 0u, 0u);
          if (on && t0 + u < bag) v[u] = load_piece(table + r * C + c);
        }
        // the next bag's ids, while this batch's rows are in flight
        if (c0 == 0 && t0 == 0)
          load_ids<G>(nxt, ids, b + stride, B, bag, 0, sub);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (t0 + u < bag) add_piece(acc, v[u], T());
        }
      }
      if (on) out[b * C + c] = pack_piece(acc, bag, mean, T());
    }
  }
}

template <typename T>
int launch_lane(const void* table, const void* ids, void* out, int B,
                int bag, long long V, int E, int mean, cudaStream_t st) {
  const unsigned blocks =
      static_cast<unsigned>((B + (long long)kWarps - 1) / kWarps);
  bag_lane_kernel<T><<<blocks, kWarps * 32, 0, st>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(ids),
      static_cast<T*>(out), B, bag, V, E, mean);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of a vector body resident on the device at once, into *ctas: the
// card's SM count times the body's occupancy, cached a device
template <typename T, int G>
cudaError_t resident_ctas(int* ctas) {
  static int cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bag_vector_kernel<T, G>, kThreads, 0);
    if (e != cudaSuccess) return e;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *ctas = cached[dev];
  return cudaSuccess;
}

template <typename T, int G>
int launch_vector_g(const void* table, const void* ids, void* out, int B,
                    int bag, long long V, int C, int mean, cudaStream_t st) {
  constexpr int kPerCta = kThreads / G;
  const long long groups = (B + (long long)kPerCta - 1) / kPerCta;
  int resident = 0;
  const cudaError_t e = resident_ctas<T, G>(&resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks =
      static_cast<unsigned>(groups < resident ? groups : resident);
  bag_vector_kernel<T, G><<<blocks, kThreads, 0, st>>>(
      static_cast<const uint4*>(table), static_cast<const int32_t*>(ids),
      static_cast<uint4*>(out), B, bag, V, C, mean);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vector(const void* table, const void* ids, void* out, int B,
                  int bag, long long V, int E, int mean, cudaStream_t st) {
  const int C = E / (16 / static_cast<int>(sizeof(T)));   // 16-B pieces
  if (C <= 1)
    return launch_vector_g<T, 1>(table, ids, out, B, bag, V, C, mean, st);
  if (C <= 2)
    return launch_vector_g<T, 2>(table, ids, out, B, bag, V, C, mean, st);
  if (C <= 4)
    return launch_vector_g<T, 4>(table, ids, out, B, bag, V, C, mean, st);
  if (C <= 8)
    return launch_vector_g<T, 8>(table, ids, out, B, bag, V, C, mean, st);
  if (C <= 16)
    return launch_vector_g<T, 16>(table, ids, out, B, bag, V, C, mean, st);
  return launch_vector_g<T, 32>(table, ids, out, B, bag, V, C, mean, st);
}

}  // namespace

// table [V, E] float32 (bf16 = 0) or bf16 (bf16 = 1), ids [B, bag] int32
// -> out [B, E] in the table's type; mean != 0 divides the sum by bag.
// vector != 0 takes the vector body: E * elem a multiple of 16 bytes,
// table and out 16-byte aligned (the wrapper's path() checks).
extern "C" int repro_embedding_bag(const void* table, const void* ids,
                                   void* out, int B, int bag, long long V,
                                   int E, int mean, int bf16, int vector,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || E == 0) return static_cast<int>(cudaGetLastError());
  if (vector)
    return bf16 ? launch_vector<uint16_t>(table, ids, out, B, bag, V, E,
                                          mean, st)
                : launch_vector<float>(table, ids, out, B, bag, V, E, mean,
                                       st);
  return bf16 ? launch_lane<uint16_t>(table, ids, out, B, bag, V, E, mean,
                                      st)
              : launch_lane<float>(table, ids, out, B, bag, V, E, mean, st);
}

// Registers and local (spilled) bytes a thread of body `which`, in the
// order of kernels/embedding_bag.py BODIES: lane fp32, lane bf16, then the
// vector bodies, fp32 and then bf16, each at G = 1, 2, 4, 8, 16, 32.
extern "C" int repro_bag_attrs(int which, int* regs, int* local_bytes) {
  static const void* const bodies[] = {
      reinterpret_cast<const void*>(bag_lane_kernel<float>),
      reinterpret_cast<const void*>(bag_lane_kernel<uint16_t>),
      reinterpret_cast<const void*>(bag_vector_kernel<float, 1>),
      reinterpret_cast<const void*>(bag_vector_kernel<float, 2>),
      reinterpret_cast<const void*>(bag_vector_kernel<float, 4>),
      reinterpret_cast<const void*>(bag_vector_kernel<float, 8>),
      reinterpret_cast<const void*>(bag_vector_kernel<float, 16>),
      reinterpret_cast<const void*>(bag_vector_kernel<float, 32>),
      reinterpret_cast<const void*>(bag_vector_kernel<uint16_t, 1>),
      reinterpret_cast<const void*>(bag_vector_kernel<uint16_t, 2>),
      reinterpret_cast<const void*>(bag_vector_kernel<uint16_t, 4>),
      reinterpret_cast<const void*>(bag_vector_kernel<uint16_t, 8>),
      reinterpret_cast<const void*>(bag_vector_kernel<uint16_t, 16>),
      reinterpret_cast<const void*>(bag_vector_kernel<uint16_t, 32>)};
  constexpr int n = sizeof(bodies) / sizeof(bodies[0]);
  if (which < 0 || which >= n) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, bodies[which]);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
