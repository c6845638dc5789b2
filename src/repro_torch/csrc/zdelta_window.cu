// Per-group window z-delta kernel-map search (Spira §5.2) for Hopper, on
// int32 or int64 packed words: the per-(tile, group) baseline beside the
// superwindow search.
//
// Replaces the TPU kernel repro/kernels/zdelta_window.py::
// zdelta_window_search (_kernel). Phase A (torch, one searchsorted per
// (128-row output tile, anchor group) for the tile's first query) gives
// each cell its window start, clamped here to [0, N − W]. What a cell
// computes is the TPU kernel's: for each (row, member) query q = row +
// anchor[g] + j·zstep, the first position of the cell's W-word window
// equal to q (the TPU kernel's (bm, W) broadcast compare; the window is
// sorted, so a branchless binary search for q's lower bound finds the same
// position). The map entry is that position plus the window start, or −1
// without a match or on a PAD output row (the reference masks PAD rows
// after its kernel).
//
// One block per 128-row output tile:
//
//   * one staged span per tile holds every group's window. Anchors ascend,
//     so the groups' starts do, and one tile's windows overlap (the
//     queries of neighbouring anchors lie close in the sorted input, and
//     a window of 512 words reaches past several of them). The block
//     stages the union of consecutive groups' windows
//     (up to 16 KB; more spans where they do not fit, each window never
//     cut) by 16-byte cp.async copies, each window being a view into it:
//     its words and the cell's results are those of the window alone.
//     Each window reaches to the next power of two of W words (the array's
//     next words, PAD past its end), so it stays sorted and the binary
//     search needs no bound check;
//   * a thread takes one row of its share of the span's groups, two groups
//     at a time, the two searches interleaved so that one's shared-memory
//     reads overlap the other's;
//   * a thread resolves its row's K members in order: a branchless binary
//     search gives member 0's position, and each next member's starts
//     from the previous one (members ascend, so it lies at or after it:
//     one or two compares, a binary search over the rest only when those
//     miss), the same first equal position as a search per member at a
//     fifth of its shared-memory reads at K = 5. Lanes hold consecutive,
//     sorted rows of one group, so they mostly read the same window word;
//   * the tile's [128, G·K] map block, or runs of its rows where it would
//     not fit 32 KB (64 rows at G = 25, K = 5, each run re-staging the
//     span), is built in shared memory across the groups and stored
//     once with 16-byte stores;
//   * a tile whose output rows are all PAD stores −1 and zero counters by
//     16-byte stores and stages nothing.
//
// Bound on this card: bytes, as the superwindow search: the map is almost
// all of them.
//
// Overflow counters: per (tile, group), the queries of real rows above the
// window's last word, counted only when the window does not reach the
// array's end. Integer adds in shared memory, so their order does not
// matter; with 128-row tiles and the same start clamp they equal the TPU
// kernel's.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "tensor_core.cuh"
#include "zdelta_common.cuh"

namespace {

using namespace spira_zd;

constexpr int kThreads = 256;
constexpr int kChunkBudget = 32 * 1024;    // bytes of map rows per pass
constexpr size_t kSpanBudget = 16 * 1024;  // bytes of a staged span

// NB, KK > 0: the binary search's steps and the members per group fixed
// at compile time (the loops unrolled); 0: taken from nbits and K.
template <typename T, int NB, int KK>
__global__ void __launch_bounds__(kThreads)
window_kernel(const T* __restrict__ arr, int n, const T* __restrict__ outp,
              const T* __restrict__ anchors, int G, T zstep,
              int K, int W, int nbits, const int32_t* __restrict__ starts,
              int rc_lg, int span_cap, int32_t* __restrict__ m_out,
              int32_t* __restrict__ ovf_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T rows_s[kTileRows];
  const int GK = G * K;
  const int rc = 1 << rc_lg;
  const int per = kThreads >> rc_lg;        // runs of rows the block holds
  const int P = 1 << nbits;                 // the searched, padded window
  const size_t mbytes = align16(static_cast<size_t>(rc) * GK * 4);
  int32_t* mbuf = reinterpret_cast<int32_t*>(smem);            // [rc, G·K]
  int* start_s = reinterpret_cast<int*>(smem + mbytes);        // [G]
  int* ovf_s = start_s + G;                                    // [G]
  T* span_s = reinterpret_cast<T*>(                            // span_cap
      smem + mbytes + align16(static_cast<size_t>(2) * G * 4));
  const int sub = threadIdx.x >> rc_lg;     // this thread's first group
  const int r = threadIdx.x & (rc - 1);     // and its row of the run
  const size_t tile = blockIdx.x;
  int32_t* tmap = m_out + tile * kTileRows * GK;
  int32_t* tovf = ovf_out + tile * G;

  if (stage_rows(outp + tile * kTileRows, rows_s)) {
    fill_minus_one(tmap, static_cast<size_t>(kTileRows) * GK);
    for (int g = threadIdx.x; g < G; g += kThreads) tovf[g] = 0;
    return;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    const int s = starts[tile * G + g];
    start_s[g] = s < 0 ? 0 : (s > n - W ? n - W : s);
    ovf_s[g] = 0;
  }
  __syncthreads();

  for (int r0 = 0; r0 < kTileRows; r0 += rc) {
    const T o = rows_s[r0 + r];
    const bool real = o != Word<T>::kPad;
    for (int gb = 0; gb < G;) {
      // a batch: the groups from gb on whose padded windows [start,
      // start + P) span at most span_cap words together
      int lo = start_s[gb], hi = lo + P, ge = gb + 1;
      for (; ge < G; ++ge) {
        const int nlo = min(lo, start_s[ge]);
        const int nhi = max(hi, start_s[ge] + P);
        if (nhi - nlo > span_cap) break;
        lo = nlo;
        hi = nhi;
      }
      const T* span = span_s + stage_words(span_s, arr, n, lo, hi - lo);
      spira_tc::cp_async_commit();
      spira_tc::cp_async_wait<0>();
      __syncthreads();
      const int cnt = ge - gb;
      for (int w0 = sub; w0 < cnt; w0 += 2 * per) {
        int g[2], start[2], pos[2], ovf[2] = {0, 0};
        bool act[2];
        const T* win[2];
        T q[2], last_val[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int w = w0 + u * per;
          act[u] = w < cnt;
          g[u] = gb + (act[u] ? w : w0);
          start[u] = start_s[g[u]];
          win[u] = span + (start[u] - lo);        // [P], W real
          last_val[u] = win[u][W - 1];
          q[u] = wrap_add(o, anchors[g[u]]);
        }
        padded_lower_bound2<NB>(win[0], win[1], nbits, q[0], q[1], pos[0],
                                pos[1]);
#pragma unroll
        for (int j = 0; j < (KK > 0 ? KK : K); ++j) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (j > 0) {
              const T prev = q[u];
              q[u] = wrap_add(q[u], zstep);
              if (q[u] < prev) {                 // wrapped: search anew
                int other;
                padded_lower_bound2<NB>(win[u], win[u], nbits, q[u], q[u],
                                        pos[u], other);
              } else if (pos[u] < P && win[u][pos[u]] < q[u]) {
                ++pos[u];
                if (pos[u] < P && win[u][pos[u]] < q[u])
                  pos[u] = lower_bound_from(win[u], pos[u] + 1, P, q[u]);
              }
            }
            const bool hit = real && pos[u] < W && win[u][pos[u]] == q[u];
            if (act[u])
              mbuf[r * GK + g[u] * K + j] = hit ? pos[u] + start[u] : -1;
            ovf[u] += real && q[u] > last_val[u] ? 1 : 0;
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (act[u] && ovf[u]) atomicAdd(&ovf_s[g[u]], ovf[u]);
      }
      __syncthreads();                    // the span is refilled next
      gb = ge;
    }
    store_block(tmap + static_cast<size_t>(r0) * GK, mbuf, rc * GK);
    __syncthreads();
  }
  for (int g = threadIdx.x; g < G; g += kThreads)
    tovf[g] = start_s[g] + W < n ? ovf_s[g] : 0;
}

template <typename T, int NB, int KK>
cudaError_t launch_as(const T* arr, int n, const T* outp, int n_tiles,
                      const T* anchors, int G, T zstep, int K, int W,
                      int nbits, const int32_t* starts, int rc_lg,
                      int span_cap, size_t smem, int32_t* m_out,
                      int32_t* ovf_out, cudaStream_t stream) {
  static int allowed = 0;
  cudaError_t e = allow_smem(window_kernel<T, NB, KK>, smem, allowed);
  if (e != cudaSuccess) return e;
  window_kernel<T, NB, KK><<<n_tiles, kThreads, smem, stream>>>(
      arr, n, outp, anchors, G, zstep, K, W, nbits, starts, rc_lg,
      span_cap, m_out, ovf_out);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* arr_v, int n, const void* outp_v, int n_tiles,
           const void* anchors_v, int G, long long zstep_ll, int K, int W,
           int nbits, const void* starts_v, void* m_out_v, void* ovf_out_v,
           void* stream_v) {
  if (W < 1 || W > n || G < 1 || K < 1 || nbits < 1 || nbits > 30 ||
      (1 << nbits) < W)
    return cudaErrorInvalidValue;
  if (n_tiles <= 0) return cudaSuccess;
  const int rc_lg = chunk_rows_log2(G, K, kChunkBudget);
  const size_t fixed = align16((static_cast<size_t>(G) * K * 4) << rc_lg) +
                       align16(static_cast<size_t>(2) * G * 4);
  // the staged span: kSpanBudget bytes, or one padded window where that
  // is wider
  const int span_cap = std::max(static_cast<int>(kSpanBudget / sizeof(T)),
                                1 << nbits);
  const size_t smem =
      fixed + static_cast<size_t>(staged_words<T>(span_cap)) * sizeof(T);
  if (smem + 2048 > kMaxSmem) return cudaErrorInvalidValue;
  const T* arr = static_cast<const T*>(arr_v);
  const T* outp = static_cast<const T*>(outp_v);
  const T* anchors = static_cast<const T*>(anchors_v);
  const int32_t* starts = static_cast<const int32_t*>(starts_v);
  const T zstep = static_cast<T>(zstep_ll);
  int32_t* m_out = static_cast<int32_t*>(m_out_v);
  int32_t* ovf_out = static_cast<int32_t*>(ovf_out_v);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  // the plan's windows: 512 words (9 steps), K = 3 or 5
#define SPIRA_W_LAUNCH(NB, KK)                                               \
  return launch_as<T, NB, KK>(arr, n, outp, n_tiles, anchors, G, zstep, K,   \
                              W, nbits, starts, rc_lg, span_cap, smem,       \
                              m_out, ovf_out, stream)
  if (nbits == 9 && K == 3) SPIRA_W_LAUNCH(9, 3);
  if (nbits == 9 && K == 5) SPIRA_W_LAUNCH(9, 5);
  SPIRA_W_LAUNCH(0, 0);
#undef SPIRA_W_LAUNCH
}

}  // namespace

// arr: sorted PAD-tailed words [n]; outp: words [n_tiles * 128]; anchors:
// words [G]; starts: int32 [n_tiles, G] (phase A); m_out: int32
// [n_tiles * 128, G * K]; ovf_out: int32 [n_tiles, G]. Words are int32
// (_i32) or int64 (_i64); PAD is the type's maximum.
extern "C" int spira_zdelta_window_i32(
    const void* arr, int n, const void* outp, int n_tiles,
    const void* anchors, int G, long long zstep, int K, int W, int nbits,
    const void* starts, void* m_out, void* ovf_out, void* stream) {
  return launch<int32_t>(arr, n, outp, n_tiles, anchors, G, zstep, K, W,
                         nbits, starts, m_out, ovf_out, stream);
}

extern "C" int spira_zdelta_window_i64(
    const void* arr, int n, const void* outp, int n_tiles,
    const void* anchors, int G, long long zstep, int K, int W, int nbits,
    const void* starts, void* m_out, void* ovf_out, void* stream) {
  return launch<int64_t>(arr, n, outp, n_tiles, anchors, G, zstep, K, W,
                         nbits, starts, m_out, ovf_out, stream);
}
