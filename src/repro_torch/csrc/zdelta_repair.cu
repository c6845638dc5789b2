// Exact re-search of the overflowed cells of a windowed z-delta kernel-map
// search (Spira §5.2), in place, for Hopper, on int32 or int64 packed words.
//
// Port-only: no pl.pallas_call stands behind it. The JAX package repairs
// these cells in XLA behind lax.cond (repro/core/network_plan.py:149,
// _pallas_map's `patched`): when any (128-row tile, anchor group) cell of
// the window search counted a query past its window, the exact z-delta
// search (repro/core/zdelta.py, zdelta_search) is run and its entries
// replace the map's in every such cell. Here that branch runs on the card,
// with no host read of the counters, so a plan that overflows its windows
// can be captured in a CUDA graph like any other.
//
// Bound on this card: bytes, and the flagged cells only. A launch must read
// every counter, and per flagged cell the tile's 128 output words and write
// 128·K map entries; each real row's binary search adds about log2(n)
// dependent reads of the input array (from L2 after the first rows of a
// cell). On a plan whose windows are sized for its traffic no cell is
// flagged, and the launch is then its counters' read and its fixed cost.
// The first version ran one block per cell (an n_tiles x G grid), so an
// unflagged launch paid the dispatch of tens of thousands of blocks that
// each read 4 bytes and returned. This one is a compact scan:
//
//   * A few blocks of 128 threads per SM (never more than the cells need),
//     grid-striding over chunks of 512 cells. The grid size follows from
//     n_tiles x G and the SM count only, never from the flagged count, so
//     the launch stays in a CUDA graph with no host read.
//   * Each thread reads four consecutive counters with one 16-byte load
//     (plain loads at a ragged tail or an unaligned base), so a warp reads
//     512 contiguous bytes; the block votes (__syncthreads_or) and skips
//     the chunk when no counter of it is nonzero.
//   * Otherwise the warps with a flagged cell (a ballot) append the cells'
//     indices to a list in shared memory, and the block repairs each listed
//     cell with its 128 threads, thread r on the tile's row r, running the
//     search of the first version: a PAD row writes −1 to its K entries; a
//     real row the lower bound of (row + anchor) over the whole sorted
//     input array [0, n), then K z-steps, the cursor advancing only on a
//     hit (sound by the Integer Property), writing the positions where the
//     query's word is found and −1 elsewhere.
//
// Cells are disjoint and each is rewritten from the inputs alone, so the
// order in which the list is filled does not matter: the map is integers
// and equals its plain version (kernels/zdelta_window.py,
// zdelta_repair_torch) exactly.
#include <cstdint>
#include <cuda_runtime.h>

#include "tensor_core.cuh"
#include "zdelta_common.cuh"

namespace {

using namespace spira_zd;

constexpr int kPerThread = 4;                       // counters per load
constexpr int kChunk = kTileRows * kPerThread;      // cells per block pass
constexpr int kBlocksPerSm = 4;

// thread threadIdx.x re-searches row threadIdx.x of cell (tile, g)
template <typename T>
__device__ __forceinline__ void repair_row(const T* __restrict__ arr, int n,
                                           const T* __restrict__ outp,
                                           const T* __restrict__ anchors,
                                           int G, T zstep, int K,
                                           int32_t* __restrict__ m,
                                           int64_t tile, int g) {
  const int64_t row = tile * kTileRows + threadIdx.x;
  int32_t* dst = m + row * static_cast<int64_t>(G) * K +
                 static_cast<int64_t>(g) * K;
  const T o = outp[row];
  if (o == Word<T>::kPad) {
    for (int k = 0; k < K; ++k) dst[k] = -1;
    return;
  }
  T q = wrap_add(o, anchors[g]);
  int cursor = lower_bound_from(arr, 0, n, q);
  for (int k = 0; k < K; ++k) {
    const bool hit = cursor < n && arr[min(cursor, n - 1)] == q &&
                     q != Word<T>::kPad;
    dst[k] = hit ? cursor : -1;
    cursor += hit ? 1 : 0;
    q = wrap_add(q, zstep);
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileRows)
repair_kernel(const T* __restrict__ arr, int n, const T* __restrict__ outp,
              const T* __restrict__ anchors, int G, T zstep, int K,
              const int32_t* __restrict__ ovf, int64_t cells,
              int32_t* __restrict__ m) {
  __shared__ int64_t list[kChunk];
  __shared__ int count;
  const bool vec = reinterpret_cast<uintptr_t>(ovf) % 16 == 0;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  for (int64_t c0 = static_cast<int64_t>(blockIdx.x) * kChunk; c0 < cells;
       c0 += static_cast<int64_t>(gridDim.x) * kChunk) {
    const int64_t c = c0 + threadIdx.x * kPerThread;
    int v[kPerThread] = {0, 0, 0, 0};
    if (vec && c + kPerThread <= cells) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(ovf + c));
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        if (c + j < cells) v[j] = ovf[c + j];
    }
    const bool any = (v[0] | v[1] | v[2] | v[3]) != 0;
    if (!__syncthreads_or(any)) continue;          // the common case
    if (__ballot_sync(0xffffffffu, any) != 0u) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        if (v[j] != 0) list[atomicAdd(&count, 1)] = c + j;
    }
    __syncthreads();
    const int flagged = count;
    for (int i = 0; i < flagged; ++i) {
      const int64_t cell = list[i];
      repair_row(arr, n, outp, anchors, G, zstep, K, m, cell / G,
                 static_cast<int>(cell % G));
    }
    __syncthreads();                 // every thread has read count and list
    if (threadIdx.x == 0) count = 0;
  }
}

template <typename T>
int launch(const void* arr, int n, const void* outp, int n_tiles,
           const void* anchors, int G, long long zstep, int K,
           const void* ovf, void* m, void* stream) {
  if (n < 1 || G < 1 || K < 1) return cudaErrorInvalidValue;
  if (n_tiles <= 0) return cudaSuccess;
  const int64_t cells = static_cast<int64_t>(n_tiles) * G;
  const int64_t need = (cells + kChunk - 1) / kChunk;
  const int blocks = static_cast<int>(
      need < int64_t{kBlocksPerSm} * spira_tc::sm_count()
          ? need : int64_t{kBlocksPerSm} * spira_tc::sm_count());
  repair_kernel<T><<<blocks, kTileRows, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(arr), n, static_cast<const T*>(outp),
      static_cast<const T*>(anchors), G, static_cast<T>(zstep), K,
      static_cast<const int32_t*>(ovf), cells, static_cast<int32_t*>(m));
  return cudaGetLastError();
}

}  // namespace

// arr: sorted PAD-tailed words [n]; outp: words [n_tiles * 128]; anchors:
// words [G]; ovf: int32 [n_tiles, G], the window search's counters; m:
// int32 [n_tiles * 128, G * K], the window search's map, repaired in place.
// Words are int32 (_i32) or int64 (_i64); PAD is the type's maximum.
extern "C" int spira_zdelta_repair_i32(const void* arr, int n,
                                       const void* outp, int n_tiles,
                                       const void* anchors, int G,
                                       long long zstep, int K,
                                       const void* ovf, void* m,
                                       void* stream) {
  return launch<int32_t>(arr, n, outp, n_tiles, anchors, G, zstep, K, ovf, m,
                         stream);
}

extern "C" int spira_zdelta_repair_i64(const void* arr, int n,
                                       const void* outp, int n_tiles,
                                       const void* anchors, int G,
                                       long long zstep, int K,
                                       const void* ovf, void* m,
                                       void* stream) {
  return launch<int64_t>(arr, n, outp, n_tiles, anchors, G, zstep, K, ovf, m,
                         stream);
}
