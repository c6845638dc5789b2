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

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_partials(const T* __restrict__ x, int C, int q,
               const int32_t* __restrict__ starts,
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
    first_row[threadIdx.x] = starts[lo] + j * q;
    rows[threadIdx.x] = min(q, counts[lo] - j * q);
  }
  __syncthreads();
  const int64_t e = e0 + threadIdx.x;
  if (e > e_last) return;
  const int c = static_cast<int>(e / C);
  const int ch = static_cast<int>(e - static_cast<int64_t>(c) * C);
  const int len = rows[c - c0];
  const T* src = x + static_cast<int64_t>(first_row[c - c0]) * C + ch;
  float acc = 0.0f;
  for (int t0 = 0; t0 < len; t0 += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = t0 + u < len ? widen(src[static_cast<int64_t>(t0 + u) * C])
                          : 0.0f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (t0 + u < len) acc = __fadd_rn(acc, v[u]);
  }
  partial[e] = acc;
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

template <typename T>
int launch(const void* x, int C, int q, const void* starts,
           const void* counts, int S, int n2, void* choff, void* partial,
           void* out, cudaStream_t st) {
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
  chunk_partials<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(x), C, q, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(counts), off, S,
      static_cast<float*>(partial));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  combine_partials<<<dim3((C + kCombineChannels - 1) / kCombineChannels,
                          S < kMaxGridY ? S : kMaxGridY),
                     32, 0, st>>>(static_cast<const float*>(partial), C, off,
                                  S, static_cast<float*>(out));
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
  return bf16 ? launch<__nv_bfloat16>(x, C, q, starts, counts, S, n2, choff,
                                      partial, out, st)
              : launch<float>(x, C, q, starts, counts, S, n2, choff, partial,
                              out, st);
}
