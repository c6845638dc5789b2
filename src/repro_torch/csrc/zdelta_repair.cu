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
// One block of 128 threads per (tile, group) cell:
//
//   1. The block reads the cell's counter and returns if it is 0. On a plan
//      whose windows are sized for its traffic that is every cell, and the
//      launch costs one 4-byte read per cell.
//   2. Otherwise thread r takes the tile's row r. A PAD row writes −1 to its
//      K entries. A real row runs exactly what zdelta_search runs for its
//      group: the lower bound of (row + anchor) over the whole sorted input
//      array [0, n), then K z-steps, the cursor advancing only on a hit
//      (sound by the Integer Property), and writes its K entries of the map
//      in place: positions where the query's word is found, −1 elsewhere.
//
// Bound on this card: bytes, and the flagged cells only. A launch must read
// every counter, and per flagged cell the tile's 128 output words and write
// 128·K map entries; each real row's binary search adds about log2(n)
// dependent reads of the input array (from L2 after the first rows of a
// cell). The design keeps the unflagged cells at one read each and does no
// other work for them; a flagged cell is a few microseconds of latency.
//
// The map is integers, so the kernel equals its plain version
// (kernels/zdelta_window.py, zdelta_repair_torch) exactly.
#include <cstdint>
#include <cuda_runtime.h>

#include "zdelta_common.cuh"

namespace {

using namespace spira_zd;

template <typename T>
__global__ void __launch_bounds__(kTileRows)
repair_kernel(const T* __restrict__ arr, int n, const T* __restrict__ outp,
              const T* __restrict__ anchors, int G, T zstep, int K,
              const int32_t* __restrict__ ovf, int32_t* __restrict__ m) {
  const size_t tile = blockIdx.x;
  const int g = blockIdx.y;
  if (ovf[tile * G + g] == 0) return;
  const size_t row = tile * kTileRows + threadIdx.x;
  int32_t* dst = m + row * static_cast<size_t>(G) * K +
                 static_cast<size_t>(g) * K;
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
int launch(const void* arr, int n, const void* outp, int n_tiles,
           const void* anchors, int G, long long zstep, int K,
           const void* ovf, void* m, void* stream) {
  if (n < 1 || G < 1 || G > 65535 || K < 1) return cudaErrorInvalidValue;
  if (n_tiles <= 0) return cudaSuccess;
  repair_kernel<T><<<dim3(n_tiles, G), kTileRows, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(arr), n, static_cast<const T*>(outp),
      static_cast<const T*>(anchors), G, static_cast<T>(zstep), K,
      static_cast<const int32_t*>(ovf), static_cast<int32_t*>(m));
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
