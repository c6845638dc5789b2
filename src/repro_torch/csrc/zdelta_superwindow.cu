// Superwindow z-delta kernel-map search (Spira §5.2) for Hopper, on int32
// or int64 packed words.
//
// Replaces the TPU kernel repro/kernels/zdelta_window.py::
// zdelta_superwindow_search (_super_kernel), phase A included. One block
// per 128-row output tile:
//
//   1. PAD tiles. A tile whose 128 output rows are all PAD stores its −1
//      map block with 16-byte stores and zero counters, and stages and
//      searches nothing. The plan's outputs are bucket-sized with a PAD
//      tail, so on coarse levels almost every tile is one of these (a
//      MinkUNet level-4 launch holds 66 real tiles of 2,048).
//   2. Phase A. The window base is the lower bound of the tile's smallest
//      query (row 0 + anchors[0]; anchors ascend) over the whole input
//      array, clamped to [0, N − SW]. The block narrows it to 64 words by
//      rounds of one sample per thread (two rounds up to N = 2^22; the
//      first round's samples do not depend on the query and are read
//      together with the tile's rows), then stages those 64 words with
//      the window and finds the base in shared memory (a search down to
//      one word before staging the window was slower per MinkUNet forward
//      in a throwaway A/B build: one more dependent round trip per tile).
//   3. Staging. arr[base, base + 2^nbits) goes to shared memory by 16-byte
//      cp.async copies (PAD past the array's end), shared by every anchor
//      group of the tile; the words past the window keep it sorted, so
//      the binary search needs no bound check.
//   4. The search. Pairs (row, group) run row-fastest within a group, so
//      the 32 lanes of a warp search 32 consecutive, sorted rows of one
//      group and mostly read the same window word (a broadcast). A
//      branchless binary search gives the anchor's lower bound, and a
//      K-step two-pointer probe (the cursor advances only on a hit, sound
//      by the Integer Property) resolves the group's K members.
//   5. The map block. A run of 2^j rows of the tile's [128, G·K] block
//      (as many as fit 32 KB: all 128 at K = 3, 64 at G = 25, K = 5) is
//      built in shared memory, then stored with 16-byte stores: the block
//      is contiguous in device memory, so each warp store instruction
//      writes four full 128-byte lines.
//
// Bound on this card: bytes. A launch reads the outputs, the anchors and,
// per real tile, a window of SW words (from L2: neighbouring tiles'
// windows overlap), and writes M·G·K map entries and the counters; the
// map is almost all of it. The design writes it at full width, PAD tiles
// at memset speed, and keeps every probe in shared memory.
//
// Overflow counters: a query above the window's last word may match past
// the window, so per (tile, group) the kernel counts such queries of real
// rows; the count is 0 when the window runs to the end of the array. They
// are integer adds in shared memory, so their order does not matter, and
// they equal the TPU kernel's counters for the same tile size (128).
#include <cstdint>
#include <cuda_runtime.h>

#include "tensor_core.cuh"
#include "zdelta_common.cuh"

namespace {

using namespace spira_zd;

constexpr int kThreads = 256;
constexpr int kMaxGroups = 128;
constexpr int kChunkBudget = 32 * 1024;   // bytes of map rows per pass
constexpr int kSlack = 64;                // base range staged with the window

// NB, KK > 0: the binary search's steps and the members per group fixed
// at compile time (the loops unrolled); 0: taken from nbits and K.
template <typename T, int NB, int KK>
__global__ void __launch_bounds__(kThreads)
superwindow_kernel(const T* __restrict__ arr, int n,
                   const T* __restrict__ outp,
                   const T* __restrict__ anchors, int G, T zstep, int K,
                   int SW, int nbits, int rc_lg, int32_t* __restrict__ m_out,
                   int32_t* __restrict__ ovf_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T rows_s[kTileRows];
  __shared__ T anch_s[kMaxGroups];
  __shared__ int ovf_s[kMaxGroups];
  const int GK = G * K;
  const int rc = 1 << rc_lg;
  int32_t* mbuf = reinterpret_cast<int32_t*>(smem);          // [rc, G·K]
  T* span_s = reinterpret_cast<T*>(
      smem + align16(static_cast<size_t>(rc) * GK * 4));      // window + slack
  const int P = 1 << nbits;                 // the searched, padded window

  const size_t tile = blockIdx.x;
  int32_t* tmap = m_out + tile * kTileRows * GK;
  int32_t* tovf = ovf_out + tile * G;

  // phase A's first round samples the whole array at a stride that does
  // not depend on the query: read together with the tile's rows
  const int step = (n + kThreads - 1) / kThreads;
  const int64_t idx = static_cast<int64_t>(threadIdx.x + 1) * step - 1;
  const T sample = idx < n ? arr[idx] : Word<T>::kPad;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    anch_s[g] = anchors[g];
    ovf_s[g] = 0;
  }
  if (stage_rows(outp + tile * kTileRows, rows_s)) {
    fill_minus_one(tmap, static_cast<size_t>(kTileRows) * GK);
    for (int g = threadIdx.x; g < G; g += kThreads) tovf[g] = 0;
    return;
  }

  // phase A: the lower bound of the tile's smallest query (row 0 +
  // anchors[0]), narrowed to kSlack words, then found in shared memory
  const T q0 = wrap_add(rows_s[0], anch_s[0]);
  int lo = __syncthreads_count(idx < n && sample < q0) * step;
  int len = min(step - 1, n - lo);
  block_narrow<T, kThreads>(arr, q0, kSlack, lo, len);
  // every base in [lo, lo + len], clamped to [0, n − SW], has its
  // window and the P − SW words after it inside [span_lo, span_hi)
  const int span_lo = min(lo, n - SW);
  const int span_hi = min(lo + len, n - SW) + P;
  const T* span =
      span_s + stage_words(span_s, arr, n, span_lo, span_hi - span_lo);
  spira_tc::cp_async_commit();
  spira_tc::cp_async_wait<0>();
  __syncthreads();
  const int base = min(span_lo + lower_bound_from(span, lo - span_lo,
                                                  lo - span_lo + len, q0),
                       n - SW);
  const T* win = span + (base - span_lo);                // [P], SW real
  const T last_val = win[SW - 1];

  const int pairs = rc * G;
  for (int r0 = 0; r0 < kTileRows; r0 += rc) {
    // two pairs per thread at a time, their searches interleaved
    for (int p0 = threadIdx.x; p0 < pairs; p0 += 2 * kThreads) {
      int g[2], cursor[2], ovf[2] = {0, 0};
      bool act[2], real[2];
      T q[2];
      int32_t* dst[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = p0 + u * kThreads;
        act[u] = p < pairs;
        const int pp = act[u] ? p : p0;
        g[u] = pp >> rc_lg;
        const int r = pp & (rc - 1);
        const T o = rows_s[r0 + r];
        real[u] = o != Word<T>::kPad;
        q[u] = wrap_add(o, anch_s[g[u]]);
        dst[u] = mbuf + r * GK + g[u] * K;
      }
      padded_lower_bound2<NB>(win, win, nbits, q[0], q[1], cursor[0],
                              cursor[1]);
#pragma unroll
      for (int k = 0; k < (KK > 0 ? KK : K); ++k) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const bool hit = real[u] && cursor[u] < SW &&
                           win[cursor[u]] == q[u];
          if (act[u]) dst[u][k] = hit ? cursor[u] + base : -1;
          ovf[u] += real[u] && q[u] > last_val ? 1 : 0;
          cursor[u] += hit ? 1 : 0;
          q[u] = wrap_add(q[u], zstep);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (act[u] && ovf[u]) atomicAdd(&ovf_s[g[u]], ovf[u]);
    }
    __syncthreads();
    store_block(tmap + static_cast<size_t>(r0) * GK, mbuf, rc * GK);
    __syncthreads();
  }
  const bool reaches_end = base + SW >= n;
  for (int g = threadIdx.x; g < G; g += kThreads)
    tovf[g] = reaches_end ? 0 : ovf_s[g];
}

template <typename T, int NB, int KK>
cudaError_t launch_as(const T* arr, int n, const T* outp, int n_tiles,
                      const T* anchors, int G, T zstep, int K, int SW,
                      int nbits, int rc_lg, size_t smem, int32_t* m_out,
                      int32_t* ovf_out, cudaStream_t stream) {
  static int allowed = 0;
  cudaError_t e = allow_smem(superwindow_kernel<T, NB, KK>, smem, allowed);
  if (e != cudaSuccess) return e;
  superwindow_kernel<T, NB, KK><<<n_tiles, kThreads, smem, stream>>>(
      arr, n, outp, anchors, G, zstep, K, SW, nbits, rc_lg, m_out, ovf_out);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* arr_v, int n, const void* outp_v, int n_tiles,
           const void* anchors_v, int G, long long zstep_ll, int K, int SW,
           int nbits, void* m_out_v, void* ovf_out_v, void* stream_v) {
  if (G < 1 || G > kMaxGroups || K < 1 || SW < 1 || SW > n || nbits < 1 ||
      nbits > 30 || (1 << nbits) < SW)
    return cudaErrorInvalidValue;
  if (n_tiles <= 0) return cudaSuccess;
  const int rc_lg = chunk_rows_log2(G, K, kChunkBudget);
  const size_t smem =
      align16((static_cast<size_t>(G) * K * 4) << rc_lg) +
      static_cast<size_t>(staged_words<T>(kSlack + (1 << nbits))) *
          sizeof(T);
  if (smem + 4096 > kMaxSmem) return cudaErrorInvalidValue;
  const T* arr = static_cast<const T*>(arr_v);
  const T* outp = static_cast<const T*>(outp_v);
  const T* anchors = static_cast<const T*>(anchors_v);
  const T zstep = static_cast<T>(zstep_ll);
  int32_t* m_out = static_cast<int32_t*>(m_out_v);
  int32_t* ovf_out = static_cast<int32_t*>(ovf_out_v);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  // the plan's windows: 2,048 words (11 steps), K = 3 or 5, and K = 2
  // (the strided maps of a residual UNet's stride-2 windows)
#define SPIRA_SW_LAUNCH(NB, KK)                                              \
  return launch_as<T, NB, KK>(arr, n, outp, n_tiles, anchors, G, zstep, K,   \
                              SW, nbits, rc_lg, smem, m_out, ovf_out, stream)
  if (nbits == 11 && K == 2) SPIRA_SW_LAUNCH(11, 2);
  if (nbits == 11 && K == 3) SPIRA_SW_LAUNCH(11, 3);
  if (nbits == 11 && K == 5) SPIRA_SW_LAUNCH(11, 5);
  SPIRA_SW_LAUNCH(0, 0);
#undef SPIRA_SW_LAUNCH
}

}  // namespace

// arr: sorted PAD-tailed words [n]; outp: words [n_tiles * 128] (sorted,
// PAD tail); anchors: words [G], ascending; m_out: int32
// [n_tiles * 128, G * K]; ovf_out: int32 [n_tiles, G]. Words are int32
// (_i32) or int64 (_i64); PAD is the type's maximum.
extern "C" int spira_zdelta_superwindow_i32(
    const void* arr, int n, const void* outp, int n_tiles,
    const void* anchors, int G, long long zstep, int K, int SW, int nbits,
    void* m_out, void* ovf_out, void* stream) {
  return launch<int32_t>(arr, n, outp, n_tiles, anchors, G, zstep, K, SW,
                         nbits, m_out, ovf_out, stream);
}

extern "C" int spira_zdelta_superwindow_i64(
    const void* arr, int n, const void* outp, int n_tiles,
    const void* anchors, int G, long long zstep, int K, int SW, int nbits,
    void* m_out, void* ovf_out, void* stream) {
  return launch<int64_t>(arr, n, outp, n_tiles, anchors, G, zstep, K, SW,
                         nbits, m_out, ovf_out, stream);
}
