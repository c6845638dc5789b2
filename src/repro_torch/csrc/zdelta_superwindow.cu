// Superwindow z-delta kernel-map search (Spira §5.2) for Hopper.
//
// Replaces the TPU kernel repro/kernels/zdelta_window.py::
// zdelta_superwindow_search (_super_kernel). One block per 128-row output
// tile stages ONE window of SW sorted packed input words in shared memory,
// shared by every anchor group of the tile. Each thread then takes
// (row, group) pairs: a branchless binary search in the window gives the
// anchor's lower bound, and a K-step two-pointer probe (cursor advances only
// on a hit, sound by the Integer Property) resolves the group's K members.
//
// Bound on this card: bytes. Per tile it reads SW + 128 words and writes
// 128 * G * K map entries; the map write dominates. The design keeps the
// probe in shared memory (the window is loaded once, coalesced) so device
// memory sees each input word once per tile and each map entry once.
//
// Overflow counters: a query above the window's last word may match past
// the window, so per (tile, group) the kernel counts such queries of real
// rows; the count is 0 when the window runs to the end of the array. They
// are integer adds in shared memory, so their order does not matter, and
// they equal the TPU kernel's counters for the same tile size (128).
//
// Packed words wrap on purpose (PAD + offset): the adds go through
// uint32_t, where wrap-around is defined.
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 128;   // network_plan.PLAN_BM
constexpr int kThreads = 256;
constexpr int kMaxGroups = 128;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__global__ void __launch_bounds__(kThreads)
superwindow_kernel(const int32_t* __restrict__ arr, int n,
                   const int32_t* __restrict__ outp,
                   const int32_t* __restrict__ anchors, int G, int32_t zstep,
                   int K, int SW, int nbits,
                   const int32_t* __restrict__ starts,
                   int32_t* __restrict__ m_out, int32_t* __restrict__ ovf_out) {
  extern __shared__ int32_t win[];          // SW words
  __shared__ int ovf_s[kMaxGroups];
  const int tile = blockIdx.x;
  int base = starts[tile];
  base = base < 0 ? 0 : (base > n - SW ? n - SW : base);
  for (int i = threadIdx.x; i < SW; i += blockDim.x) win[i] = arr[base + i];
  for (int g = threadIdx.x; g < G; g += blockDim.x) ovf_s[g] = 0;
  __syncthreads();

  const int32_t last_val = win[SW - 1];
  const int pairs = kTileRows * G;
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const int r = p / G;
    const int g = p - r * G;
    const size_t row = static_cast<size_t>(tile) * kTileRows + r;
    const int32_t o = outp[row];
    const bool real = o != INT_MAX;
    int32_t q = wrap_add(o, anchors[g]);
    // pos = number of window words < q (branchless binary search)
    int pos = 0;
    for (int sbit = nbits - 1; sbit >= 0; --sbit) {
      const int cand = pos + (1 << sbit);
      if (cand <= SW && win[cand - 1] < q) pos = cand;
    }
    int cursor = pos;
    int ovf = 0;
    int32_t* dst = m_out + row * G * K + static_cast<size_t>(g) * K;
    for (int k = 0; k < K; ++k) {
      const int c = cursor < SW ? cursor : SW - 1;
      const bool hit = real && cursor < SW && win[c] == q;
      dst[k] = hit ? cursor + base : -1;
      ovf += (real && q > last_val) ? 1 : 0;
      cursor += hit ? 1 : 0;
      q = wrap_add(q, zstep);
    }
    if (ovf) atomicAdd(&ovf_s[g], ovf);
  }
  __syncthreads();
  const bool window_reaches_end = base + SW >= n;
  for (int g = threadIdx.x; g < G; g += blockDim.x)
    ovf_out[static_cast<size_t>(tile) * G + g] =
        window_reaches_end ? 0 : ovf_s[g];
}

}  // namespace

// arr: sorted PAD-tailed int32 [n]; outp: int32 [n_tiles * 128];
// anchors: int32 [G]; starts: int32 [n_tiles] (phase A, one searchsorted per
// tile); m_out: int32 [n_tiles * 128, G * K]; ovf_out: int32 [n_tiles, G].
extern "C" int spira_zdelta_superwindow_i32(
    const void* arr, int n, const void* outp, int n_tiles,
    const void* anchors, int G, int zstep, int K, int SW, int nbits,
    const void* starts, void* m_out, void* ovf_out, void* stream) {
  if (G > kMaxGroups || SW < 1 || SW > n) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(SW) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        superwindow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  superwindow_kernel<<<n_tiles, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(arr), n, static_cast<const int32_t*>(outp),
      static_cast<const int32_t*>(anchors), G, zstep, K, SW, nbits,
      static_cast<const int32_t*>(starts), static_cast<int32_t*>(m_out),
      static_cast<int32_t*>(ovf_out));
  return cudaGetLastError();
}
