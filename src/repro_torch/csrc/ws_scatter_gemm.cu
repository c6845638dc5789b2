// Weight-stationary sparse convolution for Hopper: an output panel resident
// in shared memory, swept over the offsets in order:
//   out[i] = sum over k in column order, where pair (i, k) was kept,
//            of F[m[i,k]] @ W[k]
// with, for each offset column k, the first `capacity` valid rows (in row
// order) kept.
//
// Replaces the TPU kernel repro/kernels/ws_scatter_gemm.py::ws_scatter_gemm
// (_kernel), and follows its structure: that kernel keeps the [M, bn]
// output block in VMEM and sweeps the offsets on the TPU's sequential
// grid, which is what orders its merge. Here a block keeps a panel of 128
// rows by a Cout tile in shared memory and sweeps the offsets itself. The
// first port split the sweep into a pair GEMM writing one fp32 row per
// kept pair and a merge reading them back through an [M, Ks] pair-index
// table, behind ~10 torch ops and two host syncs per call; its merge and
// compaction moved ~10x the bound's bytes. Three kernels now, on one
// stream, with no host sync and no table sized by pairs:
//
//  * ws_pack_kernel: one block per panel stages the panel's map rows in
//    shared memory by coalesced cp.async (reading column cols[k] of a
//    row of `ld` entries, so the hybrid dataflow's WS columns are read in
//    place, not copied), then a warp per offset writes the panel rows with
//    m >= 0, in row order, as uint8 rows-in-panel into list[p][k][0..) and
//    their count into cnt[k][p]. Order comes from ballots and popc, not
//    atomics.
//  * ws_rank_kernel (lossy capacity only; capacity >= M keeps every pair
//    and the host skips it): one block per offset scans cnt[k][.] over the
//    panels; an entry's column rank is the panel's exclusive prefix plus its
//    place in the list, so the kept entries of (p, k) are the list's first
//    kept[k][p] = min(cnt, max(0, capacity - prefix)).
//  * ws_sweep_kernel: one block per (panel, Cout tile of 16, 32, 64 or 96).
//    It reads the panel's kept counts for every offset once; then, for
//    each chunk of 16 offsets, one thread per kept entry reads its row from
//    the pack's list and its input row m[row, cols[k]] (two dependent
//    loads per chunk, not per offset) into the packed lists of
//    gather_mma.cuh's run_chunk (2 stages, as the OS kernel: rings of 4, 6
//    or 8 stages took more shared memory, fewer blocks an SM, and were
//    slower on CenterPoint's launches), which gathers them
//    into 16-row mma fragments by cp.async (zero-filling ragged Cin such
//    as the stem's 5), streams W[k]'s slice beside them, multiplies on the
//    tensor cores (bf16 m16n8k16; fp32 3xTF32 on m16n8k8, each 16 channels
//    summed into a zeroed fragment, then added in round-to-nearest fp32)
//    and adds each row's sum for the offset to that row's accumulator.
//    Empty (panel, offset) lists issue nothing. The output is written
//    once, fp32; rows without kept pairs (PAD rows included) are +0.0.
//
// Add order: each output element starts at +0.0 and receives one add per
// kept offset, in offset order (a row appears at most once per offset, and
// the chunk's offsets are swept in order by the whole block). The add is
// of that offset's product summed in a fixed sequence of mma over the Cin
// slices, which depends on the row's input row and W alone. So a row's
// bits depend only on its own map row, plus the column ranks above it
// when capacity is lossy: a batch of B is bitwise equal to B single runs,
// and zero-extension to a larger bucket changes nothing. No atomics on
// sums.
//
// Bound on this card: bytes for CenterPoint's layers (F, the map and W read
// once, the fp32 output written once; the pack reads the map once more,
// and the sweep reads the kept entries of it again through L2), operations
// for MinkUNet's wide WS layers (2 * kept_pairs * Cin * Cout). The fp32
// products keep the accuracy of an fp32 sum (chip_smoke holds every fp32
// launch against a float64 reference).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gather_mma.cuh"

namespace {

using namespace spira_gm;

constexpr int kPanel = kBM;           // rows per panel (the wrapper's PANEL)
constexpr int kPackThreads = 512;
constexpr int kPackSmem = 96 * 1024;  // a pack block's staged map rows, max
constexpr int kRankThreads = 1024;

// Pack: per (panel p, offset k) the panel rows with m[row, cols[k]] >= 0,
// in row order, as rows in the panel; their count in cnt[k][p]. The map's
// rows are staged `sub_rows` at a time with an odd pitch (conflict-free
// column reads).
__global__ void __launch_bounds__(kPackThreads)
ws_pack_kernel(const int32_t* __restrict__ m, int ld,
               const int32_t* __restrict__ cols, int M, int Ks,
               int n_panels, int sub_rows, uint8_t* __restrict__ list,
               int32_t* __restrict__ cnt) {
  extern __shared__ __align__(16) int32_t rows_s[];   // [sub_rows][ldp]
  const int ldp = ld | 1;
  int* tot_s = rows_s + sub_rows * ldp;               // [Ks]
  const int p = blockIdx.x;
  const int row0 = p * kPanel;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int k = threadIdx.x; k < Ks; k += kPackThreads) tot_s[k] = 0;
  const Walk w = make_walk<kPackThreads>(ld);
  for (int s0 = 0; s0 < kPanel; s0 += sub_rows) {
    // this pass's rows: within the panel and below M
    const int n = max(0, min(min(sub_rows, kPanel - s0), M - row0 - s0));
    __syncthreads();           // the last pass's rows are done with
    const int32_t* src = m + static_cast<int64_t>(row0 + s0) * ld;
    for (int r = w.r0, c = w.c0; r < n;) {
      cp_async<4>(rows_s + r * ldp + c, src + static_cast<int64_t>(r) * ld + c,
                  true);
      r += w.dr;
      c += w.dc;
      if (c >= w.chunks) {
        c -= w.chunks;
        ++r;
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int k = threadIdx.x >> 5; k < Ks; k += kPackThreads / 32) {
      const int col = cols ? cols[k] : k;
      uint8_t* lr = list + (static_cast<int64_t>(p) * Ks + k) * kPanel;
      int total = tot_s[k];
      for (int b = 0; b < n; b += 32) {
        const int r = b + lane;
        const int v = r < n ? rows_s[r * ldp + col] : -1;
        const unsigned ball = __ballot_sync(0xffffffffu, v >= 0);
        if (v >= 0)
          lr[total + __popc(ball & below)] = static_cast<uint8_t>(s0 + r);
        total += __popc(ball);
      }
      if (lane == 0) tot_s[k] = total;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < Ks; k += kPackThreads)
    cnt[static_cast<int64_t>(k) * n_panels + p] = tot_s[k];
}

// Rank (lossy capacity): per offset k, kept[k][p] = min(cnt[k][p],
// max(0, capacity - sum of cnt[k][q] over q < p)).
__global__ void __launch_bounds__(kRankThreads)
ws_rank_kernel(const int32_t* __restrict__ cnt, int n_panels, int capacity,
               int32_t* __restrict__ kept) {
  __shared__ int warp_s[kRankThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n_panels;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int p0 = 0; p0 < n_panels; p0 += kRankThreads) {
    const int p = p0 + threadIdx.x;
    const int v = p < n_panels ? cnt[base + p] : 0;
    int x = v;                 // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_s[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int wsum = warp_s[lane];
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int y = __shfl_up_sync(0xffffffffu, wsum, d);
        if (lane >= d) wsum += y;
      }
      warp_s[lane] = wsum;
    }
    __syncthreads();
    const int excl = carry + x - v + (warp ? warp_s[warp - 1] : 0);
    if (p < n_panels) kept[base + p] = min(v, max(0, capacity - excl));
    carry += warp_s[kRankThreads / 32 - 1];
    __syncthreads();           // warp_s is rewritten by the next tile
  }
}

// Sweep: one block per (panel, Cout tile), offsets in order, the panel's
// fp32 sums resident in shared memory.
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
ws_sweep_kernel(const T* __restrict__ F, int Cin,
                const int32_t* __restrict__ m, int ld,
                const int32_t* __restrict__ cols, int M, int Ks,
                const uint8_t* __restrict__ list,
                const int32_t* __restrict__ kept, int n_panels,
                const T* __restrict__ W, int Cout, float* __restrict__ out,
                int n_col_tiles, int vecA, int vecB) {
  using L = Tile<T, BN>;
  static_assert(kKC <= 32, "a warp scans a chunk's counts");
  extern __shared__ __align__(16) char smem[];
  int* idx_s = reinterpret_cast<int*>(smem + L::kMapOffset);  // [kKC][kLdIdx]
  uint8_t* rows_s = reinterpret_cast<uint8_t*>(smem + L::kRowsOffset);
  int* cnt_s = reinterpret_cast<int*>(smem + L::kListOffset);  // [kKC]
  int* kept_s = reinterpret_cast<int*>(smem + L::kSmem);       // [Ks]
  int* col_s = kept_s + Ks;                                    // [Ks]
  int* pre_s = col_s + Ks;                                     // [kKC + 1]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x / n_col_tiles;
  const int row0 = p * kPanel;
  const int n0 = (blockIdx.x % n_col_tiles) * BN;
  const Walk wb =
      make_walk<kThreads>(BN * static_cast<int>(sizeof(T)) / vecB);

  clear_acc<T, BN>(smem);
  // the panel's kept counts and map columns, all offsets at once
  for (int k = threadIdx.x; k < Ks; k += kThreads) {
    kept_s[k] = kept[static_cast<int64_t>(k) * n_panels + p];
    col_s[k] = cols ? cols[k] : k;
  }
  for (int kc0 = 0; kc0 < Ks; kc0 += kKC) {
    const int kcn = min(kKC, Ks - kc0);
    __syncthreads();           // the last chunk's lists are done with
    if (warp == 0) {           // the chunk's counts and their prefix
      const int c = lane < kcn ? kept_s[kc0 + lane] : 0;
      int x = c;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      if (lane < kcn) {
        pre_s[lane] = x - c;
        cnt_s[lane] = c;
      }
      if (lane == 31) pre_s[kKC] = x;
    }
    __syncthreads();
    // every kept entry of the chunk, one thread each: its row in the panel
    // from the pack's list, its input row from the map
    const int total = pre_s[kKC];
    for (int e = threadIdx.x; e < total; e += kThreads) {
      int kk = 0;
      while (kk + 1 < kcn && pre_s[kk + 1] <= e) ++kk;
      const int i = e - pre_s[kk];
      const int k = kc0 + kk;
      const int r = list[(static_cast<int64_t>(p) * Ks + k) * kPanel + i];
      idx_s[kk * L::kLdIdx + i] =
          m[static_cast<int64_t>(row0 + r) * ld + col_s[k]];
      rows_s[kk * kPanel + i] = static_cast<uint8_t>(r);
    }
    run_chunk<T, BN>(smem, F, Cin,
                     W + static_cast<int64_t>(kc0) * Cin * Cout, Cout, kcn,
                     n0, vecA, wb);
  }
  store_tile<T, BN>(smem, out, row0, M, n0, Cout);
}

template <typename T, int BN>
cudaError_t launch_sweep(const void* F, int Cin, const void* m, int ld,
                         const void* cols, int M, int Ks, const void* list,
                         const void* kept, int n_panels, const void* W,
                         int Cout, void* out, cudaStream_t s) {
  auto kernel = ws_sweep_kernel<T, BN>;
  const int bytes = Tile<T, BN>::kSmem + (2 * Ks + kKC + 1) * 4;
  static int configured = 0;         // above 48 KB needs the opt-in
  if (bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = bytes;
  }
  const int n_col = (Cout + BN - 1) / BN;
  const int64_t blocks = static_cast<int64_t>(n_panels) * n_col;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  constexpr int kSize = sizeof(T);
  const int vecA = copy_bytes(F, static_cast<int64_t>(Cin) * kSize, kSize);
  const int vecB = copy_bytes(W, static_cast<int64_t>(Cout) * kSize, kSize);
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(
      static_cast<const T*>(F), Cin, static_cast<const int32_t*>(m), ld,
      static_cast<const int32_t*>(cols), M, Ks,
      static_cast<const uint8_t*>(list), static_cast<const int32_t*>(kept),
      n_panels, static_cast<const T*>(W), Cout, static_cast<float*>(out),
      n_col, vecA, vecB);
  return cudaGetLastError();
}

// Pack, and rank at a lossy capacity (capacity < M); the sweep then reads
// `kept` (or `cnt` when every pair is kept).
cudaError_t launch_pack(const void* m, int ld, const void* cols, int M,
                        int Ks, int capacity, void* list, void* cnt,
                        void* kept, cudaStream_t s) {
  if (M <= 0 || Ks <= 0) return cudaSuccess;
  const int n_panels = (M + kPanel - 1) / kPanel;
  const int ldp = ld | 1;
  const int sub_rows = min(kPanel, (kPackSmem / 4 - Ks) / ldp / 32 * 32);
  if (sub_rows < 32) return cudaErrorInvalidValue;
  static bool configured = false;    // above 48 KB needs the opt-in
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ws_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kPackSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  auto* cntp = static_cast<int32_t*>(cnt);
  ws_pack_kernel<<<n_panels, kPackThreads, (sub_rows * ldp + Ks) * 4, s>>>(
      static_cast<const int32_t*>(m), ld, static_cast<const int32_t*>(cols),
      M, Ks, n_panels, sub_rows, static_cast<uint8_t*>(list), cntp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || capacity >= M) return e;
  ws_rank_kernel<<<Ks, kRankThreads, 0, s>>>(cntp, n_panels, capacity,
                                             static_cast<int32_t*>(kept));
  return cudaGetLastError();
}

template <typename T>
int launch(const void* F, int Cin, const void* m, int ld, const void* cols,
           int M, int Ks, const void* W, int Cout, int capacity, void* list,
           void* cnt, void* kept, void* out, int bn, void* stream) {
  if (M <= 0 || Cout <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      launch_pack(m, ld, cols, M, Ks, capacity, list, cnt, kept, s);
  if (e != cudaSuccess) return e;
  const int n_panels = (M + kPanel - 1) / kPanel;
  const void* kp = capacity < M ? kept : cnt;
  switch (bn) {
    case 16: return launch_sweep<T, 16>(F, Cin, m, ld, cols, M, Ks, list, kp,
                                        n_panels, W, Cout, out, s);
    case 32: return launch_sweep<T, 32>(F, Cin, m, ld, cols, M, Ks, list, kp,
                                        n_panels, W, Cout, out, s);
    case 64: return launch_sweep<T, 64>(F, Cin, m, ld, cols, M, Ks, list, kp,
                                        n_panels, W, Cout, out, s);
    case 96: return launch_sweep<T, 96>(F, Cin, m, ld, cols, M, Ks, list, kp,
                                        n_panels, W, Cout, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// F: [N, Cin]; W: [Ks, Cin, Cout] (one type, fp32 or bf16); m: int32 rows of
// `ld` entries, M of them, of which offset k reads column cols[k] (cols:
// int32 [Ks], or null for column k); capacity: pairs kept per offset
// (>= M: all); list: uint8 [ceil(M / 128), Ks, 128] and cnt, kept: int32
// [Ks, ceil(M / 128)] scratch (kept unused when capacity >= M); out: fp32
// [M, Cout]; bn: the Cout tile (16, 32, 64 or 96). All contiguous.
// spira_ws_pack runs the pack and rank kernels alone.
extern "C" int spira_ws_pack(const void* m, int ld, const void* cols, int M,
                             int Ks, int capacity, void* list, void* cnt,
                             void* kept, void* stream) {
  return launch_pack(m, ld, cols, M, Ks, capacity, list, cnt, kept,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int spira_ws_scatter_gemm_f32(
    const void* F, int Cin, const void* m, int ld, const void* cols, int M,
    int Ks, const void* W, int Cout, int capacity, void* list, void* cnt,
    void* kept, void* out, int bn, void* stream) {
  return launch<float>(F, Cin, m, ld, cols, M, Ks, W, Cout, capacity, list,
                       cnt, kept, out, bn, stream);
}

extern "C" int spira_ws_scatter_gemm_bf16(
    const void* F, int Cin, const void* m, int ld, const void* cols, int M,
    int Ks, const void* W, int Cout, int capacity, void* list, void* cnt,
    void* kept, void* out, int bn, void* stream) {
  return launch<__nv_bfloat16>(F, Cin, m, ld, cols, M, Ks, W, Cout, capacity,
                               list, cnt, kept, out, bn, stream);
}
