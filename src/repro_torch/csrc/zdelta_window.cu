// Per-group window z-delta kernel-map search (Spira §5.2) for Hopper: the
// per-(tile, group) baseline beside the superwindow search.
//
// Replaces the TPU kernel repro/kernels/zdelta_window.py::
// zdelta_window_search (_kernel). Phase A (torch, one searchsorted per
// (128-row output tile, anchor group) for the tile's first query) gives each
// cell its window start. Here one block per (tile, group) stages
// arr[clamp(start, 0, n - W) : + W] in shared memory, and its threads take
// (row, member) pairs: q = row + anchor[g] + r * zstep, and the match is the
// first window position equal to q. The TPU kernel finds it with a (bm, W)
// broadcast compare per member; the window is sorted, so here a branchless
// binary search for q's lower bound finds the same position. The map entry
// is that position plus the window start, or -1 without a match or on a PAD
// output row (the reference masks PAD rows after its kernel).
//
// Overflow counters: per (tile, group), the queries of real rows above the
// window's last word, counted only when the window does not reach the
// array's end. Integer adds in shared memory, so their order does not
// matter; with 128-row tiles and the same start clamp they equal the TPU
// kernel's.
//
// Bound on this card: bytes. Per cell it reads W + 128 words and writes
// 128 * K map entries; the K^2 windows of a tile overlap, so device memory
// sees each input word up to K^2 times per tile (the superwindow kernel
// loads one window per tile). The window sits in shared memory, so each
// probe costs log2(W) shared reads and no device-memory traffic.
//
// Packed words wrap on purpose (PAD + offset): the adds go through uint32_t,
// where wrap-around is defined.
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 128;   // network_plan.PLAN_BM
constexpr int kThreads = 128;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__global__ void __launch_bounds__(kThreads)
window_kernel(const int32_t* __restrict__ arr, int n,
              const int32_t* __restrict__ outp,
              const int32_t* __restrict__ anchors, int G, int32_t zstep,
              int K, int W, int nbits, const int32_t* __restrict__ starts,
              int32_t* __restrict__ m_out, int32_t* __restrict__ ovf_out) {
  extern __shared__ int32_t win[];          // W words
  __shared__ int ovf_s;
  const int tile = blockIdx.x;
  const int g = blockIdx.y;
  int start = starts[static_cast<size_t>(tile) * G + g];
  start = start < 0 ? 0 : (start > n - W ? n - W : start);
  for (int i = threadIdx.x; i < W; i += blockDim.x) win[i] = arr[start + i];
  if (threadIdx.x == 0) ovf_s = 0;
  __syncthreads();

  const int32_t last_val = win[W - 1];
  const int32_t anchor = anchors[g];
  const size_t row_stride = static_cast<size_t>(G) * K;
  int ovf = 0;
  for (int p = threadIdx.x; p < kTileRows * K; p += blockDim.x) {
    const int r = p / K;
    const int j = p - r * K;
    const size_t row = static_cast<size_t>(tile) * kTileRows + r;
    const int32_t o = outp[row];
    const bool real = o != INT_MAX;
    const int32_t q = wrap_add(
        wrap_add(o, anchor),
        static_cast<int32_t>(static_cast<uint32_t>(j) *
                             static_cast<uint32_t>(zstep)));
    // pos = number of window words < q: the first position where q may sit
    int pos = 0;
    for (int sbit = nbits - 1; sbit >= 0; --sbit) {
      const int cand = pos + (1 << sbit);
      if (cand <= W && win[cand - 1] < q) pos = cand;
    }
    const bool hit = real && pos < W && win[pos] == q;
    m_out[row * row_stride + static_cast<size_t>(g) * K + j] =
        hit ? pos + start : -1;
    ovf += (real && q > last_val) ? 1 : 0;
  }
  if (ovf) atomicAdd(&ovf_s, ovf);
  __syncthreads();
  if (threadIdx.x == 0)
    ovf_out[static_cast<size_t>(tile) * G + g] = start + W < n ? ovf_s : 0;
}

}  // namespace

// arr: sorted PAD-tailed int32 [n]; outp: int32 [n_tiles * 128];
// anchors: int32 [G]; starts: int32 [n_tiles, G] (phase A); m_out: int32
// [n_tiles * 128, G * K]; ovf_out: int32 [n_tiles, G].
extern "C" int spira_zdelta_window_i32(
    const void* arr, int n, const void* outp, int n_tiles,
    const void* anchors, int G, int zstep, int K, int W, int nbits,
    const void* starts, void* m_out, void* ovf_out, void* stream) {
  if (W < 1 || W > n || G < 1 || G > 65535) return cudaErrorInvalidValue;
  if (n_tiles <= 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(W) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  window_kernel<<<dim3(n_tiles, G), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(arr), n, static_cast<const int32_t*>(outp),
      static_cast<const int32_t*>(anchors), G, zstep, K, W, nbits,
      static_cast<const int32_t*>(starts), static_cast<int32_t*>(m_out),
      static_cast<int32_t*>(ovf_out));
  return cudaGetLastError();
}
