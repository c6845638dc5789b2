// Segment sums under the canonical schedule, for Hopper.
//
// Replaces the TPU kernel repro/kernels/segsum.py::segment_sum_pallas
// (_segsum_kernel). The schedule (that module's doc): rows of a segment are
// chunked by their position relative to the segment start (rel / q); within
// a chunk fp32 adds run strictly in row order from +0.0; chunk partials
// combine strictly in chunk order from +0.0; rows outside every segment are
// skipped. The TPU walks it with a sequential grid; here it runs in three
// kernels on the stream, with no host work between them:
//   0. chunk_offsets (one block): each segment's first chunk slot, the
//      exclusive scan of ceil(counts / q), and the total in choff[S]. The
//      chunk table is never built on the host.
//   1. chunk_partials: one thread per (used chunk slot, channel), flat, so
//      no lane idles for any C. The first threads of a block find the
//      segments of the block's few slots by a binary search of choff and
//      stage their start rows and lengths in shared memory; then each
//      thread issues all of its chunk's q = 64 row loads before its adds
//      (bf16 rows widened exactly in registers) and adds them in row
//      order. Neighbouring threads read neighbouring channels. (A
//      grid-stride loop with a search per thread and 16 loads ahead was
//      slower.)
//   2. combine_partials: one warp per (segment, 32 channels) streams the
//      segment's chunk partials through shared memory in 64-row tiles, a
//      ring of 5 filled by cp.async (4 tiles in flight), and each lane adds
//      its channel strictly in chunk order. The chain of a capacity-long
//      segment (the bias gradient: 4,096 chunks) costs its 4,096 dependent
//      adds, not 4,096 dependent global loads.
//
// The fp32 sums use no atomics, no shuffles, no trees, and the library is
// built without fast math: every add is one IEEE fp32 add (__fadd_rn) in
// the schedule's order, so the result is bitwise equal to the plain
// version (and to the JAX reference).
//
// Bound on this card: bytes (each valid row read once, one add per
// element); the combine's chain of adds is the floor for a long segment.
//
// The fused ReLU + per-scene BN epilogue of an inference forward (fp32)
// runs the same schedule on the raw convolution output:
//   relu_bn_moments: chunk_partials reading z = relu(x + bias), rows at
//      or past the valid count set to +0 before the ReLU, and summing z
//      and z * z from one load into the [slots, 2C] partials that a
//      segment sum of concat([z, z * z]) would hold; chunk_offsets and
//      combine_partials run as above, so the moments are bitwise that sum.
//   relu_bn_apply: y = (z - mean[sid]) * inv[sid] on the rows of a
//      segment, +0 on every other row, z recomputed in registers; 16-byte
//      loads and stores where C % 4 == 0.
// The torch chain it replaces (bias add, row mask, relu, x * x, cat,
// segment sum, segment gather, sub, mul, where) rounds after every op; each
// op here is the same single IEEE op (__fadd_rn, __fmul_rn, __fsub_rn, no
// contraction into an FMA), and the ReLU is ATen's clamp_min (NaN kept,
// fmaxf otherwise), so the result is bitwise the chain's.
//
// The other norm orders of a residual network's bias-free convolutions
// (standardisation first) are variants of the same two kernels:
//   moments: chunk_partials<ZRows>, the moments of z = x itself (no
//      bias, no ReLU), then combine_partials as above;
//   bn_relu_apply, bn_apply, bn_add_relu_apply: y = (x - mean[sid]) *
//      inv[sid] on the rows of a segment, +0 on the others, then ReLU
//      (bn_relu), nothing (bn), or the ReLU of y + r with a residual
//      operand r [cap, C] read on every row (bn_add_relu: a residual join).
// Each is the same single IEEE op as its chain's (relu(standardise(x)),
// standardise(x), relu(standardise(x) + r)), so bitwise that chain.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

using namespace spira_tc;

constexpr int kScanThreads = 1024;
constexpr int kThreads = 256;
constexpr int kUnroll = 64;          // row loads in flight per thread
constexpr int kCombineChannels = 32; // one warp per (segment, 32 channels)
constexpr int kTileRows = 64;        // chunk partials per shared tile
constexpr int kRing = 5;             // tiles in the ring (40 KB)
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);    // exact
}

// ATen's CUDA relu (clamp_min at 0): NaN passes through, fmaxf otherwise.
__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

// The epilogue's input row: where(row < count, x + b, 0), then relu.
// has_b false: no add; lim <= 0 masks the row (no count: never).
__device__ __forceinline__ float relu_row(float x, bool has_b, float b,
                                          int lim) {
  if (lim <= 0) return relu(0.0f);
  return relu(has_b ? __fadd_rn(x, b) : x);
}

// What chunk_partials sums. A Rows policy gives a thread's cursor over its
// chunk's rows of one channel (load(t): row t of the chunk, read through
// the read-only path; value(v, t): the loaded v as the row it stands for,
// widened) and the kSums summands of that value, stored as kSums channel
// blocks of C in each partial row. The loads of a batch are all issued
// before the first value is formed.
template <typename T>
struct RawRows {                    // the rows as they are: a segment sum
  static constexpr int kSums = 1;
  const T* x;
  struct Cursor {
    const T* p;
    int C;
    __device__ __forceinline__ T load(int t) const {
      return __ldg(p + static_cast<int64_t>(t) * C);
    }
    __device__ __forceinline__ float value(T v, int) const {
      return widen(v);
    }
  };
  __device__ __forceinline__ Cursor at(int row, int ch, int C) const {
    return {x + static_cast<int64_t>(row) * C + ch, C};
  }
  static __device__ __forceinline__ float term(int, float v) { return v; }
};

struct ReluRows {                   // the epilogue's z: sums of z and z * z
  static constexpr int kSums = 2;
  const float* x;
  const float* bias;                // null: no bias
  const int32_t* count;             // null: no row mask
  struct Cursor {
    const float* p;
    int C;
    bool has_b;
    float b;                        // the channel's bias
    int lim;                        // rows of the chunk before the mask
    __device__ __forceinline__ float load(int t) const {
      return t < lim ? __ldg(p + static_cast<int64_t>(t) * C) : 0.0f;
    }
    __device__ __forceinline__ float value(float v, int t) const {
      return relu_row(v, has_b, b, lim - t);
    }
  };
  __device__ __forceinline__ Cursor at(int row, int ch, int C) const {
    return {x + static_cast<int64_t>(row) * C + ch, C, bias != nullptr,
            bias ? __ldg(bias + ch) : 0.0f,
            count ? __ldg(count) - row : 0x7fffffff};
  }
  static __device__ __forceinline__ float term(int k, float v) {
    return k == 0 ? v : __fmul_rn(v, v);
  }
};

struct ZRows {                      // z = x itself: sums of z and z * z
  static constexpr int kSums = 2;
  const float* x;
  using Cursor = RawRows<float>::Cursor;
  __device__ __forceinline__ Cursor at(int row, int ch, int C) const {
    return {x + static_cast<int64_t>(row) * C + ch, C};
  }
  static __device__ __forceinline__ float term(int k, float v) {
    return k == 0 ? v : __fmul_rn(v, v);
  }
};

// choff[s] = sum_{s' < s} ceil(counts[s'] / q); choff[S] = the total.
__global__ void __launch_bounds__(kScanThreads)
chunk_offsets(const int32_t* __restrict__ counts, int S, int q,
              int32_t* __restrict__ choff) {
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ int carry_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < S; base += kScanThreads) {
    const int s = base + threadIdx.x;
    const int n = s < S ? (counts[s] + q - 1) / q : 0;
    int incl = n;                   // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < kScanThreads / 32 ? warp_sum[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += v;
      }
      if (lane < kScanThreads / 32) warp_sum[lane] = w;   // inclusive
      if (lane == kScanThreads / 32 - 1) carry_s = carry + w;
    }
    __syncthreads();
    const int before = warp > 0 ? warp_sum[warp - 1] : 0;
    if (s < S) choff[s] = carry + before + incl - n;
    carry = carry_s;
    __syncthreads();                // warp_sum and carry_s are reused
  }
  if (threadIdx.x == 0) choff[S] = carry;
}

template <typename Rows>
__global__ void __launch_bounds__(kThreads)
chunk_partials(Rows rows_in, int C, int q,
               const int32_t* __restrict__ starts,   // null: one from row 0
               const int32_t* __restrict__ counts,
               const int32_t* __restrict__ choff, int S,
               float* __restrict__ partial) {
  __shared__ int first_row[kThreads + 1];
  __shared__ int rows[kThreads + 1];
  const int64_t total = static_cast<int64_t>(choff[S]) * C;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  if (e0 >= total) return;
  const int64_t e_last = (e0 + kThreads < total ? e0 + kThreads : total) - 1;
  const int c0 = static_cast<int>(e0 / C);
  if (threadIdx.x <= static_cast<int>(e_last / C) - c0) {
    // the slot's segment: the last s with choff[s] <= c (empty segments
    // share their successor's offset and lose to it)
    const int c = c0 + threadIdx.x;
    int lo = 0, hi = S;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (choff[mid] <= c) lo = mid; else hi = mid;
    }
    const int j = c - choff[lo];
    first_row[threadIdx.x] = (starts ? starts[lo] : 0) + j * q;
    rows[threadIdx.x] = min(q, counts[lo] - j * q);
  }
  __syncthreads();
  const int64_t e = e0 + threadIdx.x;
  if (e > e_last) return;
  const int c = static_cast<int>(e / C);
  const int ch = static_cast<int>(e - static_cast<int64_t>(c) * C);
  const int len = rows[c - c0];
  const auto src = rows_in.at(first_row[c - c0], ch, C);
  float acc[Rows::kSums];
#pragma unroll
  for (int k = 0; k < Rows::kSums; ++k) acc[k] = 0.0f;
  for (int t0 = 0; t0 < len; t0 += kUnroll) {
    using V = decltype(src.load(0));
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = t0 + u < len ? src.load(t0 + u) : V{};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (t0 + u < len) {
        const float z = src.value(v[u], t0 + u);
#pragma unroll
        for (int k = 0; k < Rows::kSums; ++k)
          acc[k] = __fadd_rn(acc[k], Rows::term(k, z));
      }
  }
  float* dst = partial + static_cast<int64_t>(c) * Rows::kSums * C + ch;
#pragma unroll
  for (int k = 0; k < Rows::kSums; ++k) dst[static_cast<int64_t>(k) * C] =
      acc[k];
}

// One tile of chunk partials [rows, cw] into shared memory ([row][32]).
__device__ __forceinline__ void load_tile(float* dst, const float* src, int C,
                                          int rows, int cw, bool vec4) {
  const int lane = threadIdx.x;
  if (vec4) {                       // C % 4 == 0: 8 copies of 16 B a row
    for (int e = lane; e < rows * 8; e += 32) {
      const int r = e >> 3;
      const int c = (e & 7) * 4;
      if (c < cw)
        cp_async<16>(dst + r * kCombineChannels + c,
                     src + static_cast<int64_t>(r) * C + c, true);
    }
  } else {
    for (int r = 0; r < rows; ++r)
      if (lane < cw)
        cp_async<4>(dst + r * kCombineChannels + lane,
                    src + static_cast<int64_t>(r) * C + lane, true);
  }
}

__global__ void __launch_bounds__(32)
combine_partials(const float* __restrict__ partial, int C,
                 const int32_t* __restrict__ choff, int S,
                 float* __restrict__ out) {
  __shared__ __align__(16) float ring[kRing][kTileRows * kCombineChannels];
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kCombineChannels;
  const int cw = min(kCombineChannels, C - c0);
  const bool vec4 = (C & 3) == 0;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const int base = choff[s];
    const int n = choff[s + 1] - base;
    const int tiles = (n + kTileRows - 1) / kTileRows;
    const float* src = partial + static_cast<int64_t>(base) * C + c0;
    auto issue = [&](int tl) {
      load_tile(ring[tl % kRing],
                src + static_cast<int64_t>(tl) * kTileRows * C, C,
                min(kTileRows, n - tl * kTileRows), cw, vec4);
    };
#pragma unroll
    for (int tl = 0; tl < kRing - 1; ++tl) {
      if (tl < tiles) issue(tl);
      cp_async_commit();
    }
    float acc = 0.0f;
    for (int tl = 0; tl < tiles; ++tl) {
      cp_async_wait<kRing - 2>();
      __syncwarp();                 // tile tl landed; tile tl - 1 is read
      if (tl + kRing - 1 < tiles) issue(tl + kRing - 1);
      cp_async_commit();
      const int rows = min(kTileRows, n - tl * kTileRows);
      const float* t = ring[tl % kRing] + lane;
      if (lane < cw) {
        int r = 0;
        for (; r + 8 <= rows; r += 8) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = t[(r + u) * kCombineChannels];
#pragma unroll
          for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, v[u]);
        }
        for (; r < rows; ++r) acc = __fadd_rn(acc, t[r * kCombineChannels]);
      }
    }
    cp_async_wait<0>();
    __syncwarp();                   // the ring is free for the next segment
    if (lane < cw) out[static_cast<int64_t>(s) * C + c0 + lane] = acc;
  }
}

// V consecutive floats, one 16-byte access where V = 4.
template <int V>
__device__ __forceinline__ void load_v(const float* p, float* d) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) d[u] = p[u];
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float* d) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) p[u] = d[u];
  }
}

// The norm orders of the apply pass.
enum Order { kReluBn, kBnRelu, kBn, kBnAddRelu };

// y = (z - mean[s]) * inv[s] on rows of segment s < S, +0 on the others,
// then as the order says (the file's head); stats [S, 2C] = concat([mean,
// inv]). z = relu(where(row < *count, x + bias, 0)) for kReluBn, x itself
// for the others (bias and count null). V channels a thread (V = 4:
// 16-byte loads and stores, C % 4 == 0 and every pointer 16-byte aligned).
template <int V, int O>
__device__ __forceinline__ void norm_apply(
    const float* __restrict__ x, const float* __restrict__ bias,
    const int32_t* __restrict__ count,
    const int32_t* __restrict__ sid,     // null: row < counts[0]
    const int32_t* __restrict__ counts, const float* __restrict__ stats,
    const float* __restrict__ res, int S, int cap, int C,
    float* __restrict__ y) {
  const int cv = C / V;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<int64_t>(cap) * cv) return;
  const int row = static_cast<int>(e / cv);
  const int c = static_cast<int>(e - static_cast<int64_t>(row) * cv) * V;
  const int s = sid ? sid[row] : (row < counts[0] ? 0 : 1);
  float out[V];
  if (s < S) {
    float xv[V], bv[V], mv[V], iv[V];
    const float* st = stats + static_cast<int64_t>(s) * 2 * C + c;
    load_v<V>(x + static_cast<int64_t>(row) * C + c, xv);
    load_v<V>(st, mv);
    load_v<V>(st + C, iv);
    if (O == kReluBn && bias) load_v<V>(bias + c, bv);
    const int lim = (O == kReluBn && count ? *count : 0x7fffffff) - row;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const float z = O == kReluBn
                          ? relu_row(xv[u], bias != nullptr,
                                     bias ? bv[u] : 0.0f, lim)
                          : xv[u];
      out[u] = __fmul_rn(__fsub_rn(z, mv[u]), iv[u]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) out[u] = 0.0f;
  }
  if (O == kBnRelu) {
#pragma unroll
    for (int u = 0; u < V; ++u) out[u] = relu(out[u]);
  }
  if (O == kBnAddRelu) {
    float rv[V];
    load_v<V>(res + static_cast<int64_t>(row) * C + c, rv);
#pragma unroll
    for (int u = 0; u < V; ++u) out[u] = relu(__fadd_rn(out[u], rv[u]));
  }
  store_v<V>(y + static_cast<int64_t>(row) * C + c, out);
}

// One kernel per order, named for it, so a device trace tells them apart.
#define SPIRA_NORM_APPLY(NAME, O)                                            \
  template <int V>                                                           \
  __global__ void __launch_bounds__(kThreads)                                \
  NAME(const float* __restrict__ x, const float* __restrict__ bias,          \
       const int32_t* __restrict__ count, const int32_t* __restrict__ sid,   \
       const int32_t* __restrict__ counts, const float* __restrict__ stats,  \
       const float* __restrict__ res, int S, int cap, int C,                 \
       float* __restrict__ y) {                                              \
    norm_apply<V, O>(x, bias, count, sid, counts, stats, res, S, cap, C, y); \
  }
SPIRA_NORM_APPLY(relu_bn_apply, kReluBn)
SPIRA_NORM_APPLY(bn_relu_apply, kBnRelu)
SPIRA_NORM_APPLY(bn_apply, kBn)
SPIRA_NORM_APPLY(bn_add_relu_apply, kBnAddRelu)
#undef SPIRA_NORM_APPLY

using ApplyKernel = void (*)(const float*, const float*, const int32_t*,
                             const int32_t*, const int32_t*, const float*,
                             const float*, int, int, int, float*);

int launch_apply(ApplyKernel k4, ApplyKernel k1, const void* x,
                 const void* bias, const void* count, const void* sid,
                 const void* counts, const void* stats, const void* res,
                 int S, int cap, int C, int vec4, void* y, void* stream) {
  if (C <= 0 || cap <= 0) return cudaSuccess;
  if (vec4 && C % 4 != 0) return cudaErrorInvalidValue;
  const int64_t work = static_cast<int64_t>(cap) * (vec4 ? C / 4 : C);
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  (vec4 ? k4 : k1)<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(bias),
      static_cast<const int32_t*>(count), static_cast<const int32_t*>(sid),
      static_cast<const int32_t*>(counts), static_cast<const float*>(stats),
      static_cast<const float*>(res), S, cap, C, static_cast<float*>(y));
  return cudaGetLastError();
}

template <typename Rows>
int launch(Rows rows, int C, int q, const void* starts, const void* counts,
           int S, int n2, void* choff, void* partial, void* out,
           cudaStream_t st) {
  int32_t* off = static_cast<int32_t*>(choff);
  chunk_offsets<<<1, kScanThreads, 0, st>>>(
      static_cast<const int32_t*>(counts), S, q, off);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // a block per 256 (slot, channel) pairs of the most slots there can be;
  // blocks past the used slots return at once
  const int64_t blocks = (static_cast<int64_t>(n2) * C + kThreads - 1) /
                         kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  chunk_partials<Rows><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      rows, C, q, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(counts), off, S,
      static_cast<float*>(partial));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int width = Rows::kSums * C;  // the partials' and sums' channels
  combine_partials<<<dim3((width + kCombineChannels - 1) / kCombineChannels,
                          S < kMaxGridY ? S : kMaxGridY),
                     32, 0, st>>>(static_cast<const float*>(partial), width,
                                  off, S, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// x: [cap, C] fp32 (bf16 = 0) or bf16 (bf16 = 1); starts / counts: int32
// [S]; q: chunk rows; n2 = cap / q + S, the most chunk slots there can be;
// choff: int32 scratch [S + 1]; partial: fp32 scratch [n2, C]; out: fp32
// [S, C]. All contiguous.
extern "C" int spira_segment_sum(const void* x, int bf16, int C, int q,
                                 const void* starts, const void* counts,
                                 int S, int n2, void* choff, void* partial,
                                 void* out, void* stream) {
  if (C <= 0 || S <= 0) return cudaSuccess;
  if (q <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch(RawRows<__nv_bfloat16>{
                           static_cast<const __nv_bfloat16*>(x)},
                       C, q, starts, counts, S, n2, choff, partial, out, st)
              : launch(RawRows<float>{static_cast<const float*>(x)}, C, q,
                       starts, counts, S, n2, choff, partial, out, st);
}

// The epilogue's moments: out [S, 2C] = the segment sums of
// concat([z, z * z]). order (Order): kReluBn takes z = relu(where(row <
// *count, x + bias, 0)), with bias [C] fp32 or null (no add) and count
// int32 [1] or null (no mask); the other orders z = x itself, with bias
// and count null. x: [cap, C] fp32; starts: int32 [S] or null (S = 1,
// from row 0); partial: fp32 scratch [n2, 2C]; the rest as
// spira_segment_sum's.
extern "C" int spira_epilogue_moments(const void* x, const void* bias,
                                      const void* count, int order, int C,
                                      int q, const void* starts,
                                      const void* counts, int S, int n2,
                                      void* choff, void* partial, void* out,
                                      void* stream) {
  if (order < kReluBn || order > kBnAddRelu) return cudaErrorInvalidValue;
  if (order != kReluBn && (bias || count)) return cudaErrorInvalidValue;
  if (C <= 0 || S <= 0) return cudaSuccess;
  if (q <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  if (order != kReluBn)
    return launch(ZRows{xf}, C, q, starts, counts, S, n2, choff, partial,
                  out, st);
  return launch(ReluRows{xf, static_cast<const float*>(bias),
                         static_cast<const int32_t*>(count)},
                C, q, starts, counts, S, n2, choff, partial, out, st);
}

// The epilogue's apply: y [cap, C] fp32 from x, bias and count as
// spira_epilogue_moments takes them for the order, and stats [S, 2C] =
// concat([mean, inv]); res [cap, C] fp32 for kBnAddRelu, null otherwise;
// sid: int32 [cap], or null with S = 1 and segment 0 the rows below
// counts[0]. vec4: C % 4 == 0 and x, bias, stats, res, y 16-byte aligned.
extern "C" int spira_epilogue_apply(const void* x, const void* bias,
                                    const void* count, const void* sid,
                                    const void* counts, const void* stats,
                                    const void* res, int order, int S,
                                    int cap, int C, int vec4, void* y,
                                    void* stream) {
  if (order != kReluBn && (bias || count)) return cudaErrorInvalidValue;
  if ((order == kBnAddRelu) != (res != nullptr)) return cudaErrorInvalidValue;
  switch (order) {
    case kReluBn:
      return launch_apply(relu_bn_apply<4>, relu_bn_apply<1>, x, bias, count,
                          sid, counts, stats, res, S, cap, C, vec4, y,
                          stream);
    case kBnRelu:
      return launch_apply(bn_relu_apply<4>, bn_relu_apply<1>, x, bias, count,
                          sid, counts, stats, res, S, cap, C, vec4, y,
                          stream);
    case kBn:
      return launch_apply(bn_apply<4>, bn_apply<1>, x, bias, count, sid,
                          counts, stats, res, S, cap, C, vec4, y, stream);
    case kBnAddRelu:
      return launch_apply(bn_add_relu_apply<4>, bn_add_relu_apply<1>, x, bias,
                          count, sid, counts, stats, res, S, cap, C, vec4, y,
                          stream);
    default:
      return cudaErrorInvalidValue;
  }
}

