// Segment sums under the canonical schedule, for Hopper.
//
// Replaces the TPU kernel repro/kernels/segsum.py::segment_sum_pallas
// (_segsum_kernel). The schedule (that module's doc): rows of a segment are
// chunked by their position relative to the segment start (rel / q); within
// a chunk fp32 adds run strictly in row order from +0.0; chunk partials
// combine strictly in chunk order from +0.0; rows outside every segment are
// skipped. The TPU walks it with a sequential grid; here it runs in two
// passes, each thread owning one sequential chain:
//   1. one thread per (chunk slot, channel) adds its chunk's <= q rows;
//   2. one thread per (segment, channel) adds its chunk partials.
// The chunk table (start and length per slot, chunk offsets and counts per
// segment) comes from the wrapper, computed exactly as segment_sum_xla does.
//
// No atomics, no shuffles, no trees, and the library is built without fast
// math: every add is one IEEE fp32 add in the schedule's order, so the
// result is bitwise equal to the plain version (and to the JAX reference).
//
// Bound on this card: bytes (each valid row read once, adds are 1 per
// element). Neighbouring channels sit on neighbouring threads, so each
// step of a chain is a coalesced row read across the warp.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
chunk_partials(const float* __restrict__ x, int C,
               const int32_t* __restrict__ chunk_start,
               const int32_t* __restrict__ chunk_len, int n2,
               float* __restrict__ partial) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= C) return;
  for (int c = blockIdx.y; c < n2; c += gridDim.y) {
    const int len = chunk_len[c];
    const float* src = x + static_cast<size_t>(chunk_start[c]) * C + ch;
    float acc = 0.0f;
    for (int t = 0; t < len; ++t) acc = acc + src[static_cast<size_t>(t) * C];
    partial[static_cast<size_t>(c) * C + ch] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
combine_partials(const float* __restrict__ partial, int C,
                 const int32_t* __restrict__ choff,
                 const int32_t* __restrict__ nch, int S,
                 float* __restrict__ out) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= C) return;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const float* src = partial + static_cast<size_t>(choff[s]) * C + ch;
    const int n = nch[s];
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) acc = acc + src[static_cast<size_t>(j) * C];
    out[static_cast<size_t>(s) * C + ch] = acc;
  }
}

}  // namespace

// x: fp32 [cap, C]; chunk_start / chunk_len: int32 [n2]; choff: int32
// [S + 1]; nch: int32 [S]; partial: fp32 scratch [n2, C]; out: fp32 [S, C].
extern "C" int spira_segment_sum_f32(
    const void* x, int C, const void* chunk_start, const void* chunk_len,
    int n2, const void* choff, const void* nch, int S, void* partial,
    void* out, void* stream) {
  if (C <= 0 || S <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gx = (C + kThreads - 1) / kThreads;
  if (n2 > 0) {
    chunk_partials<<<dim3(gx, n2 < kMaxGridY ? n2 : kMaxGridY), kThreads, 0,
                     st>>>(static_cast<const float*>(x), C,
                           static_cast<const int32_t*>(chunk_start),
                           static_cast<const int32_t*>(chunk_len), n2,
                           static_cast<float*>(partial));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  combine_partials<<<dim3(gx, S < kMaxGridY ? S : kMaxGridY), kThreads, 0,
                     st>>>(static_cast<const float*>(partial), C,
                           static_cast<const int32_t*>(choff),
                           static_cast<const int32_t*>(nch), S,
                           static_cast<float*>(out));
  return cudaGetLastError();
}
