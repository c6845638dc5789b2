// Building blocks shared by the two z-delta kernel-map searches
// (zdelta_superwindow.cu, zdelta_window.cu): packed-word traits for int32
// and int64 words, the wrap-around add, lower bounds (block-wide over the
// sorted input array, and by interleaved branchless searches in shared
// memory), 16-byte staging of runs of words, the PAD test of a tile's
// output rows, and the coalesced stores of a tile's map block.
//
// Both kernels write a map [M, G·K] int32 whose 128-row tile is one
// contiguous block of 128·G·K words (512·G·K bytes, so every tile's and
// every 4-row chunk's block starts on a 16-byte boundary). They build the
// block, or a run of its rows, in shared memory and store it with 16-byte
// stores; a tile whose 128 output rows are all PAD stores −1 the same way
// and searches nothing.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace spira_zd {

constexpr int kTileRows = 128;   // network_plan.PLAN_BM

// PAD is the word type's maximum; adds wrap through the unsigned type of
// the same width, where wrap-around is defined (PAD + offset wraps on
// purpose, as in the reference).
template <typename T> struct Word;
template <> struct Word<int32_t> {
  using U = uint32_t;
  static constexpr int32_t kPad = 0x7fffffff;
};
template <> struct Word<int64_t> {
  using U = uint64_t;
  static constexpr int64_t kPad = 0x7fffffffffffffffLL;
};

template <typename T>
__device__ __forceinline__ T wrap_add(T a, T b) {
  using U = typename Word<T>::U;
  return static_cast<T>(static_cast<U>(a) + static_cast<U>(b));
}

// Narrow [lo, lo + len], the range holding the number of words of arr[0,
// n) below q, by the whole block (every thread gets the result) until len
// is at most `slack`: each round reads one sample per thread at an even
// stride over the range, and the count of samples below q (a prefix, arr
// being sorted) cuts the range by the block's size. Every thread of the
// block must call it.
template <typename T, int Threads>
__device__ __forceinline__ void block_narrow(const T* __restrict__ arr, T q,
                                             int slack, int& lo, int& len) {
  while (len > slack) {
    const int step = (len + Threads - 1) / Threads;
    const int64_t idx = static_cast<int64_t>(lo) +
                        static_cast<int64_t>(threadIdx.x + 1) * step - 1;
    const bool less = idx < static_cast<int64_t>(lo) + len && arr[idx] < q;
    const int next = lo + __syncthreads_count(less) * step;
    len = min(step - 1, lo + len - next);
    lo = next;
  }
}

// First position in [lo, hi] whose word is >= q (hi if none), all words
// before lo being below q.
template <typename T>
__device__ __forceinline__ int lower_bound_from(const T* __restrict__ w,
                                                int lo, int hi, T q) {
  int len = hi - lo;
  while (len > 0) {
    const int half = len >> 1;
    if (w[lo + half] < q) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

// Numbers of words of wa below qa and of wb below qb, two independent
// branchless binary searches of `nbits` steps (NB when NB > 0: unrolled)
// over w[0, 2^nbits), interleaved so that one's shared-memory reads
// overlap the other's. The words there must be sorted (a window's words
// followed by the array's next words, PAD past its end), so no step needs
// a bound check; positions at or past the window's own length mean "no
// word of the window is >= q", as they do for a search with bounds.
template <int NB, typename T>
__device__ __forceinline__ void padded_lower_bound2(
    const T* __restrict__ wa, const T* __restrict__ wb, int nbits, T qa,
    T qb, int& pa, int& pb) {
  const int nb = NB > 0 ? NB : nbits;
  pa = 0;
  pb = 0;
#pragma unroll
  for (int sbit = nb - 1; sbit >= 0; --sbit) {
    const int step = 1 << sbit;
    const T va = wa[pa + step - 1];
    const T vb = wb[pb + step - 1];
    pa += va < qa ? step : 0;
    pb += vb < qb ? step : 0;
  }
}

// Words per 16-byte copy.
template <typename T> constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// Words a staged run of `count` words may take: the run starts up to one
// copy before its first word.
template <typename T>
__host__ __device__ inline int staged_words(int count) {
  return (count + 2 * kVec<T> - 1) / kVec<T> * kVec<T>;
}

// Offset of arr[lo] in a run staged by stage_words from lo.
template <typename T>
__device__ __forceinline__ int stage_offset(const T* arr, int lo) {
  const int phase = static_cast<int>(
      (reinterpret_cast<uintptr_t>(arr) / sizeof(T)) % kVec<T>);
  return (lo + phase) % kVec<T>;
}

// Stage arr[lo, lo + count) into shared memory at dst (16-byte aligned) by
// 16-byte cp.async copies from the 16-byte boundary of arr at or before lo;
// words past n read as PAD. Returns the offset of arr[lo] in dst. Edge
// copies (before 0, across or past n) go word by word. The caller commits
// and waits.
template <typename T>
__device__ __forceinline__ int stage_words(T* __restrict__ dst,
                                           const T* __restrict__ arr, int n,
                                           int lo, int count) {
  constexpr int V = kVec<T>;
  const int off = stage_offset(arr, lo);
  const int a = lo - off;                    // a 16-byte boundary of arr
  const int chunks = (off + count + V - 1) / V;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int g0 = a + c * V;
    if (g0 >= 0 && g0 + V <= n) {
      spira_tc::cp_async<16>(dst + c * V, arr + g0, true);
    } else {
      for (int e = 0; e < V; ++e) {
        const int g = g0 + e;
        dst[c * V + e] = g >= 0 && g < n ? arr[g] : Word<T>::kPad;
      }
    }
  }
  return off;
}

// Stage the tile's 128 output rows in rows_s (threads 0..127) and return,
// in every thread, whether all of them are PAD. A barrier.
template <typename T>
__device__ __forceinline__ bool stage_rows(const T* __restrict__ rows,
                                           T* __restrict__ rows_s) {
  bool pad = true;
  if (threadIdx.x < kTileRows) {
    const T o = rows[threadIdx.x];
    rows_s[threadIdx.x] = o;
    pad = o == Word<T>::kPad;
  }
  return __syncthreads_and(pad) != 0;
}

// dst[0, words) = −1 by 16-byte stores; dst 16-byte aligned, words % 4 == 0.
__device__ __forceinline__ void fill_minus_one(int32_t* __restrict__ dst,
                                               size_t words) {
  int4* d = reinterpret_cast<int4*>(dst);
  const int4 v = make_int4(-1, -1, -1, -1);
  for (size_t i = threadIdx.x; i < words / 4; i += blockDim.x) d[i] = v;
}

// dst[0, words) = src[0, words) (shared → global) by 16-byte moves; both
// 16-byte aligned, words % 4 == 0.
__device__ __forceinline__ void store_block(int32_t* __restrict__ dst,
                                            const int32_t* __restrict__ src,
                                            int words) {
  int4* d = reinterpret_cast<int4*>(dst);
  const int4* s = reinterpret_cast<const int4*>(src);
  for (int i = threadIdx.x; i < words / 4; i += blockDim.x) d[i] = s[i];
}

// Rows of a tile's map block built at a time: the largest power of two
// (at most 128, at least 4) whose rows of G·K int32 entries fit `budget`
// bytes. Returned as its log2.
inline int chunk_rows_log2(int G, int K, int budget) {
  int lg = 7;
  while (lg > 2 && (static_cast<int64_t>(G) * K * 4 << lg) > budget) --lg;
  return lg;
}

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

// Raise the kernel's dynamic shared memory limit once per size it grows to
// (the default 48 KB counts the static shared memory too).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int& allowed) {
  if (static_cast<int>(bytes) <= allowed) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) allowed = static_cast<int>(bytes);
  return e;
}

constexpr size_t kMaxSmem = 227 * 1024;   // a block's limit on sm_90

}  // namespace spira_zd
