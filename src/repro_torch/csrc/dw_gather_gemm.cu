// Weight gradient of a sparse convolution, per offset, gather fused in,
// on Hopper's tensor cores:
//   dW[k] = sum_r G_k[r]^T g[r],   G_k[r] = F[m[r,k]] (0 where m[r,k] < 0)
//
// A port-only kernel: the JAX reference computes this contraction
// (repro/core/dataflow.py::_dw_per_offset) in XLA, outside any Pallas
// kernel. The contraction runs over the capacity-sized row axis, and the
// port fixes its grouping: rows are cut into panels of Q = 4096 rows from
// row 0, each panel's sum is a function of that panel's own valid rows
// only, and the panel partials combine in panel order from +0.0. That is
// what keeps weight gradients bitwise equal when the buffer is
// zero-extended to a larger capacity bucket: the appended PAD rows carry
// m = -1 and change no panel's rows. It rules out atomics on the sums and
// any split of the row axis other than the panels.
//
// What bounds it on this card: operations for the wide layers (2 * nnz *
// Cin * Cout useful), the gathered rows' bytes for the narrow ones. The
// first version ran fp32 fmaf on the CUDA cores over unpacked 16-row steps
// staged synchronously, at 1.87 TFLOP/s. This one runs in three kernels:
//
//  * dw_pack_kernel: one block per sub-panel (512 rows for Kd = 27) stages
//    the sub-panel's map rows in shared memory with coalesced cp.async
//    (a strided read of one offset's column would touch a cache line per
//    row), then a warp per offset compacts the rows with m[r,k] >= 0, in
//    row order, into that sub-panel's part of the (k, panel) list of (map
//    entry, row) by ballots. It adds its count to the panel's, and the
//    sub-panel that first makes a (k, panel) nonempty appends it to the
//    work list. A panel's list depends on its valid rows alone; steps of
//    zeros are never run.
//  * dw_mma_kernel: persistent blocks of 8 warps take work units (k, panel,
//    Cin x Cout tile) from an atomic counter; which block takes which unit
//    changes no arithmetic. A unit stages its packed list in shared memory
//    (the sub-panel lists concatenated in order, all loads issued at once),
//    then runs 64-row stages through a 2-stage cp.async ring: the gathered
//    F[m] rows (A = G_k^T, Cin x rows) and the matching g rows (B, rows x
//    Cout) of stage s + 1 load while stage s multiplies (3 or 4 stages of
//    32 rows were a few percent slower). Copies are 16, 8 or 4 bytes as
//    the row and base allow (2-byte loads for odd bf16 rows), zero-filled
//    past the list and the channel edges. The tile is BM x BN = 32 MI x
//    32 NI (MI, NI in 1..3, from the wrapper's _tile_for on Cin, Cout and
//    the dtype, never on M): up to 96 channels are one tile, so the stem
//    (Cin 4) runs a 32-channel tile and a 96 x 96 layer reads each
//    gathered row once; 128- and 256-wide layers run 64-wide tiles. Warps
//    are 2 (Cin) x 4 (Cout), each 16 MI x 8 NI.
//  * dw_combine_kernel: one thread per (k, i, j) adds the partials of the
//    panels that have rows, in panel order, from +0.0 (a panel without rows
//    would add +0.0, which changes no sum that starts at +0.0); it loads 8
//    panels' partials ahead of their adds.
//
// MMA. A is stored as the gathered rows ([row][channel]), so an A fragment
// is a transposed read: bf16 takes it by ldmatrix.x4.trans from rows padded
// by 16 bytes; fp32 has no 32-bit ldmatrix.trans and reads 32-bit words
// from rows padded by 8 words, which puts the 32 lanes of every fragment
// load on 32 banks. B likewise.
//  * bf16: mma.m16n8k16 with fp32 accumulators; products are exact.
//  * fp32: 3xTF32 on mma.m16n8k8: each operand splits into hi = rna_tf32(x)
//    and lo = rna_tf32(x - hi), and each fragment takes a_lo.b_hi, then
//    a_hi.b_lo, then a_hi.b_hi (the dropped a_lo.b_lo is below 2^-22 of the
//    product). The tensor cores' own accumulate truncates, so each 16 rows
//    (two k8 steps) sum into a zeroed fragment that is added to the unit's
//    accumulator by one round-to-nearest fp32 add. chip_smoke.py holds
//    every fp32 launch against a float64 gather-GEMM: the kernel's max
//    error must stay within max(4x the plain fp32 version's, 1e-6 max|ref|).
//
// Add order: for each (k, panel, i, j) a fixed sequence of mma over the
// packed list's 8-row (fp32) or 16-row (bf16) steps, grouped by step index;
// then the panels in order. Same list, same bits.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

using namespace spira_tc;

constexpr int kPanel = 4096;      // rows per panel (the wrapper's PANEL)
constexpr int kThreads = 256;     // 8 warps: 2 along Cin x 4 along Cout
constexpr int kStageRows = 64;    // packed rows per pipeline stage
constexpr int kStages = 2;
constexpr int kPackThreads = 512;
constexpr int kPackSmem = 96 * 1024;   // a pack block's staged map rows, max
constexpr int kMaxSub = kPanel / 32;   // sub-panels are >= 32 rows
constexpr int kCombineThreads = 256;
constexpr int kCombineAhead = 8;

template <typename T> struct Mma;
template <> struct Mma<float> {
  static constexpr int kDepth = 8;   // m16n8k8 tf32
};
template <> struct Mma<__nv_bfloat16> {
  static constexpr int kDepth = 16;  // m16n8k16 bf16
};

// Shared memory of a block: kStages x (A: 64 gathered rows of BM channels,
// B: 64 rows of BN output channels), rows padded by 8 elements; then the
// unit's packed list (map entries, rows in the panel).
template <typename T, int MI, int NI> struct Tile {
  static constexpr int kBM = 32 * MI;
  static constexpr int kBN = 32 * NI;
  static constexpr int kLdA = kBM + 8;   // elements
  static constexpr int kLdB = kBN + 8;
  static constexpr int kABytes = kStageRows * kLdA * sizeof(T);
  static constexpr int kStageBytes =
      kABytes + kStageRows * kLdB * static_cast<int>(sizeof(T));
  static constexpr int kListOffset = kStages * kStageBytes;
  static constexpr int kRowsOffset = kListOffset + kPanel * 4;
  static constexpr int kSmem = kRowsOffset + kPanel * 2;
};

// Pack: per (k, sub-panel) the rows with m[r, k] >= 0 in row order, at
// the sub-panel's offset in the (k, panel) list; counts per sub-panel and
// per panel; the (k, panel)s with rows appended to `items`.
__global__ void __launch_bounds__(kPackThreads)
dw_pack_kernel(const int32_t* __restrict__ m, int M, int Kd, int P,
               int sub_rows, int n_sub, int32_t* __restrict__ list_m,
               uint16_t* __restrict__ list_r, int32_t* __restrict__ cnt_sub,
               int32_t* __restrict__ cnt, int32_t* __restrict__ items,
               int32_t* __restrict__ n_items) {
  extern __shared__ __align__(16) int32_t rows_s[];   // [sub_rows][Kd]
  const int p = blockIdx.x / n_sub;
  const int sub = blockIdx.x - p * n_sub;
  const int r0 = p * kPanel + sub * sub_rows;
  const int n = max(0, min(sub_rows, M - r0));
  const int32_t* src = m + static_cast<int64_t>(r0) * Kd;
  for (int e = threadIdx.x; e < n * Kd; e += kPackThreads)
    cp_async<4>(rows_s + e, src + e, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int k = threadIdx.x >> 5; k < Kd; k += kPackThreads / 32) {
    const int64_t kp = static_cast<int64_t>(k) * P + p;
    int32_t* lm = list_m + kp * kPanel + sub * sub_rows;
    uint16_t* lr = list_r + kp * kPanel + sub * sub_rows;
    int total = 0;
    for (int b = 0; b < n; b += 32) {
      const int r = b + lane;
      const int v = r < n ? rows_s[r * Kd + k] : -1;
      const unsigned ball = __ballot_sync(0xffffffffu, v >= 0);
      if (v >= 0) {
        const int pos = total + __popc(ball & below);
        lm[pos] = v;
        lr[pos] = static_cast<uint16_t>(sub * sub_rows + r);
      }
      total += __popc(ball);
    }
    if (lane == 0) {
      cnt_sub[kp * n_sub + sub] = total;
      if (total > 0 && atomicAdd(cnt + kp, total) == 0)
        items[atomicAdd(n_items, 1)] = static_cast<int32_t>(kp);
    }
  }
}

// Issue the copies of one stage: packed rows [q0, q0 + 64) of the unit's
// list — A: F[list_m[q]] channels [i0, i0 + BM); B: g[row0 + list_r[q]]
// channels [j0, j0 + BN); zeros past the list and the channel edges.
template <typename T, int MI, int NI>
__device__ __forceinline__ void load_stage(
    char* stage, int q0, int cnt, const int32_t* s_m, const uint16_t* s_r,
    const T* F, int Cin, int i0, const T* g, int Cout, int64_t row0, int j0,
    int vecA, int vecB, const Walk& wa, const Walk& wb) {
  using L = Tile<T, MI, NI>;
  constexpr int kSize = sizeof(T);
  const int per_a = vecA / kSize;
  for (int r = wa.r0, c = wa.c0; r < kStageRows;) {
    const int q = q0 + r;
    const int i = c * per_a;
    const bool ok = q < cnt && i0 + i < Cin;
    const T* src = ok ? F + static_cast<int64_t>(s_m[q]) * Cin + i0 + i : F;
    copy_chunk(stage + (r * L::kLdA + i) * kSize,
               reinterpret_cast<const char*>(src), ok, vecA);
    r += wa.dr;
    c += wa.dc;
    if (c >= wa.chunks) {
      c -= wa.chunks;
      ++r;
    }
  }
  char* bs = stage + L::kABytes;
  const int per_b = vecB / kSize;
  for (int r = wb.r0, c = wb.c0; r < kStageRows;) {
    const int q = q0 + r;
    const int j = c * per_b;
    const bool ok = q < cnt && j0 + j < Cout;
    const T* src = ok ? g + (row0 + s_r[q]) * Cout + j0 + j : g;
    copy_chunk(bs + (r * L::kLdB + j) * kSize,
               reinterpret_cast<const char*>(src), ok, vecB);
    r += wb.dr;
    c += wb.dc;
    if (c >= wb.chunks) {
      c -= wb.chunks;
      ++r;
    }
  }
}

// One stage's `nk` k-steps of 8 rows (fp32, 3xTF32): warp tile rows
// [rm, rm + 16 MI) of Cin, columns [cn, cn + 8 NI) of Cout. Each 16 rows
// sum into `part`, which is then added to `acc` in fp32.
template <int MI, int NI>
__device__ __forceinline__ void mma_stage(const char* stage, int nk, int rm,
                                          int cn, int g, int t,
                                          float (&acc)[MI][NI][4],
                                          float (&part)[MI][NI][4], float) {
  using L = Tile<float, MI, NI>;
  const float* as = reinterpret_cast<const float*>(stage);
  const float* bs = reinterpret_cast<const float*>(stage + L::kABytes);
  for (int kk = 0; kk < nk; ++kk) {
    const float* a0 = as + (kk * 8 + t) * L::kLdA + rm + g;
    const float* a4 = a0 + 4 * L::kLdA;
    const float* b0 = bs + (kk * 8 + t) * L::kLdB + cn + g;
    const float* b4 = b0 + 4 * L::kLdB;
    uint32_t bh[NI][2], bl[NI][2];
#pragma unroll
    for (int nj = 0; nj < NI; ++nj) {
      tf32_split(b0[nj * 8], bh[nj][0], bl[nj][0]);
      tf32_split(b4[nj * 8], bh[nj][1], bl[nj][1]);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      uint32_t ah[4], al[4];
      tf32_split(a0[mi * 16], ah[0], al[0]);
      tf32_split(a0[mi * 16 + 8], ah[1], al[1]);
      tf32_split(a4[mi * 16], ah[2], al[2]);
      tf32_split(a4[mi * 16 + 8], ah[3], al[3]);
      // each fragment takes a_lo.b_hi, then a_hi.b_lo, then a_hi.b_hi
#pragma unroll
      for (int nj = 0; nj < NI; ++nj)
        mma_tf32(part[mi][nj], al, bh[nj][0], bh[nj][1]);
#pragma unroll
      for (int nj = 0; nj < NI; ++nj)
        mma_tf32(part[mi][nj], ah, bl[nj][0], bl[nj][1]);
#pragma unroll
      for (int nj = 0; nj < NI; ++nj)
        mma_tf32(part[mi][nj], ah, bh[nj][0], bh[nj][1]);
    }
    if ((kk & 1) || kk + 1 == nk) {    // every 16 rows, round to nearest
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < NI; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mi][nj][e] = __fadd_rn(acc[mi][nj][e], part[mi][nj][e]);
            part[mi][nj][e] = 0.0f;
          }
    }
  }
}

// One stage's `nk` k-steps of 16 rows (bf16, m16n8k16, fp32 accumulators).
template <int MI, int NI>
__device__ __forceinline__ void mma_stage(const char* stage, int nk, int rm,
                                          int cn, int, int,
                                          float (&acc)[MI][NI][4],
                                          float (&)[MI][NI][4],
                                          __nv_bfloat16) {
  using L = Tile<__nv_bfloat16, MI, NI>;
  const int lane = threadIdx.x & 31;
  const char* bs = stage + L::kABytes;
  // A (stored [row][channel]): matrices (i 0-7, r 0-7), (i 8-15, r 0-7),
  // (i 0-7, r 8-15), (i 8-15, r 8-15) by ldmatrix.trans
  const int a_row = (lane & 7) + (lane >> 4) * 8;
  const int a_col = rm + ((lane >> 3) & 1) * 8;
  // B (stored [row][channel]): (r 0-7, n), (r 8-15, n), then n + 8
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = cn + (lane >> 4) * 8;
  for (int kk = 0; kk < nk; ++kk) {
    uint32_t b[(NI + 1) / 2][4];
#pragma unroll
    for (int nj = 0; nj < NI; nj += 2)
      ldmatrix_x4_trans(b[nj / 2],
                        smem_u32(bs + ((kk * 16 + b_row) * L::kLdB + b_col +
                                       nj * 8) * 2));
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, smem_u32(stage + ((kk * 16 + a_row) * L::kLdA +
                                             a_col + mi * 16) * 2));
#pragma unroll
      for (int nj = 0; nj < NI; ++nj)
        mma_bf16(acc[mi][nj], a, b[nj / 2][(nj & 1) * 2],
                 b[nj / 2][(nj & 1) * 2 + 1]);
    }
  }
}

template <typename T, int MI, int NI>
__global__ void __launch_bounds__(kThreads, 2)
dw_mma_kernel(const T* __restrict__ F, int Cin, const T* __restrict__ g,
              int Cout, int P, const int32_t* __restrict__ list_m,
              const uint16_t* __restrict__ list_r,
              const int32_t* __restrict__ cnt_sub, int n_sub, int sub_shift,
              const int32_t* __restrict__ cnt_kp,
              const int32_t* __restrict__ items, int32_t* __restrict__ ctr,
              int tiles_n, int tiles, float* __restrict__ partial, int vecA,
              int vecB) {
  using L = Tile<T, MI, NI>;
  constexpr int kDepth = Mma<T>::kDepth;
  extern __shared__ __align__(16) char smem[];
  int32_t* s_m = reinterpret_cast<int32_t*>(smem + L::kListOffset);
  uint16_t* s_r = reinterpret_cast<uint16_t*>(smem + L::kRowsOffset);
  __shared__ int s_unit;
  __shared__ int s_pre[kMaxSub];    // the sub-panel lists' packed offsets

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g4 = lane >> 2;
  const int t4 = lane & 3;
  const int rm = (warp >> 2) * 16 * MI;   // warp's Cin rows in the tile
  const int cn = (warp & 3) * 8 * NI;     // warp's Cout columns
  constexpr int kSize = sizeof(T);
  const Walk wa = make_walk<kThreads>(L::kBM * kSize / vecA);
  const Walk wb = make_walk<kThreads>(L::kBN * kSize / vecB);
  const int n_units = ctr[0] * tiles;     // items written by dw_pack_kernel

  for (;;) {
    if (threadIdx.x == 0) s_unit = atomicAdd(ctr + 1, 1);
    __syncthreads();   // also: the last unit's reads of shared memory are done
    const int w = s_unit;
    if (w >= n_units) break;
    const int item = w / tiles;
    const int tile = w - item * tiles;
    const int kp = items[item];
    const int k = kp / P;
    const int p = kp - k * P;
    const int cnt = cnt_kp[kp];
    const int i0 = (tile / tiles_n) * L::kBM;
    const int j0 = (tile % tiles_n) * L::kBN;
    if (warp == 0) {            // exclusive scan of the sub-panel counts
      const int32_t* cs = cnt_sub + static_cast<int64_t>(kp) * n_sub;
      int c[kMaxSub / 32], sum = 0;
#pragma unroll
      for (int j = 0; j < kMaxSub / 32; ++j) {
        const int i = lane * (kMaxSub / 32) + j;
        c[j] = i < n_sub ? cs[i] : 0;
        sum += c[j];
      }
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      int ex = incl - sum;
#pragma unroll
      for (int j = 0; j < kMaxSub / 32; ++j) {
        s_pre[lane * (kMaxSub / 32) + j] = ex;
        ex += c[j];
      }
    }
    __syncthreads();
    const int64_t lbase = static_cast<int64_t>(kp) * kPanel;
#pragma unroll
    for (int i = 0; i < kPanel / kThreads; ++i) {
      const int e = i * kThreads + threadIdx.x;
      const int sub = e >> sub_shift;
      const int at = s_pre[sub] + (e & ((1 << sub_shift) - 1));
      const int end = sub + 1 < n_sub ? s_pre[sub + 1] : cnt;
      if (at < end) {
        s_m[at] = list_m[lbase + e];
        s_r[at] = list_r[lbase + e];
      }
    }
    __syncthreads();

    float acc[MI][NI][4], part[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < NI; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mi][nj][e] = 0.0f;
          part[mi][nj][e] = 0.0f;
        }
    const int n_stages = (cnt + kStageRows - 1) / kStageRows;
    const int64_t row0 = static_cast<int64_t>(p) * kPanel;
    auto issue = [&](int s) {
      load_stage<T, MI, NI>(smem + (s % kStages) * L::kStageBytes,
                            s * kStageRows, cnt, s_m, s_r, F, Cin, i0, g,
                            Cout, row0, j0, vecA, vecB, wa, wb);
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_stages) issue(s);
      cp_async_commit();
    }
    for (int s = 0; s < n_stages; ++s) {
      cp_async_wait<kStages - 2>();
      __syncthreads();        // stage s landed; stage s - 1's reads are done
      if (s + kStages - 1 < n_stages) issue(s + kStages - 1);
      cp_async_commit();
      const int rows = min(kStageRows, cnt - s * kStageRows);
      mma_stage<MI, NI>(smem + (s % kStages) * L::kStageBytes,
                        (rows + kDepth - 1) / kDepth, rm, cn, g4, t4, acc,
                        part, T());
    }
    cp_async_wait<0>();

    float* dst = partial + static_cast<int64_t>(kp) * Cin * Cout;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + rm + mi * 16 + g4 + 8 * h;
        if (i >= Cin) continue;
#pragma unroll
        for (int nj = 0; nj < NI; ++nj) {
          const int j = j0 + cn + nj * 8 + 2 * t4;
          float* d = dst + static_cast<int64_t>(i) * Cout + j;
          if (j < Cout) d[0] = acc[mi][nj][2 * h];
          if (j + 1 < Cout) d[1] = acc[mi][nj][2 * h + 1];
        }
      }
  }
}

__global__ void __launch_bounds__(kCombineThreads)
dw_combine_kernel(const float* __restrict__ partial,
                  const int32_t* __restrict__ cnt, int Kd, int P,
                  int per_k, float* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kCombineThreads +
                    threadIdx.x;
  if (e >= static_cast<int64_t>(Kd) * per_k) return;
  const int64_t k = e / per_k;
  const int64_t ij = e - k * per_k;
  const float* src = partial + k * P * per_k + ij;
  const int32_t* c = cnt + k * P;
  float acc = 0.0f;
  for (int p0 = 0; p0 < P; p0 += kCombineAhead) {
    bool has[kCombineAhead];
    float v[kCombineAhead];
#pragma unroll
    for (int u = 0; u < kCombineAhead; ++u) {
      has[u] = p0 + u < P && c[p0 + u] > 0;
      v[u] = has[u] ? src[static_cast<int64_t>(p0 + u) * per_k] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kCombineAhead; ++u)
      if (has[u]) acc = __fadd_rn(acc, v[u]);
  }
  out[e] = acc;
}

// Rows of a pack block: the largest power of two from 512 down to 32 whose
// map rows fit kPackSmem (0 if none does).
int pack_rows(int Kd) {
  for (int r = 512; r >= 32; r >>= 1)
    if (static_cast<int64_t>(r) * Kd * 4 <= kPackSmem) return r;
  return 0;
}

struct Lists {
  const int32_t* list_m;
  const uint16_t* list_r;
  const int32_t* cnt_sub;
  int n_sub, sub_shift;
  const int32_t* cnt;
  const int32_t* items;
  int32_t* ctr;
};

template <typename T, int MI, int NI>
int launch_mma(const void* F, int Cin, const void* g, int Cout, int Kd, int P,
               const Lists& l, void* partial, cudaStream_t s) {
  using L = Tile<T, MI, NI>;
  auto kernel = dw_mma_kernel<T, MI, NI>;
  static int per_sm = 0;      // resident blocks per SM, after the opt-in
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, L::kSmem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  const int tiles_n = (Cout + L::kBN - 1) / L::kBN;
  const int tiles = (Cin + L::kBM - 1) / L::kBM * tiles_n;
  const int64_t units = static_cast<int64_t>(Kd) * P * tiles;
  if (units > 0x7fffffff) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(
      units < static_cast<int64_t>(sm_count()) * per_sm
          ? units
          : static_cast<int64_t>(sm_count()) * per_sm);
  constexpr int kSize = sizeof(T);
  const int vecA = copy_bytes(F, static_cast<int64_t>(Cin) * kSize, kSize);
  const int vecB = copy_bytes(g, static_cast<int64_t>(Cout) * kSize, kSize);
  kernel<<<blocks, kThreads, L::kSmem, s>>>(
      static_cast<const T*>(F), Cin, static_cast<const T*>(g), Cout, P,
      l.list_m, l.list_r, l.cnt_sub, l.n_sub, l.sub_shift, l.cnt, l.items,
      l.ctr, tiles_n, tiles, static_cast<float*>(partial), vecA, vecB);
  return cudaGetLastError();
}

template <typename T>
int launch_tile(int mi, int ni, const void* F, int Cin, const void* g,
                int Cout, int Kd, int P, const Lists& l, void* partial,
                cudaStream_t s) {
#define SPIRA_DW_TILE(A, B)                                                 \
  if (mi == A && ni == B)                                                   \
    return launch_mma<T, A, B>(F, Cin, g, Cout, Kd, P, l, partial, s);
  SPIRA_DW_TILE(1, 1) SPIRA_DW_TILE(1, 2) SPIRA_DW_TILE(1, 3)
  SPIRA_DW_TILE(2, 1) SPIRA_DW_TILE(2, 2) SPIRA_DW_TILE(2, 3)
  SPIRA_DW_TILE(3, 1) SPIRA_DW_TILE(3, 2) SPIRA_DW_TILE(3, 3)
#undef SPIRA_DW_TILE
  return cudaErrorInvalidValue;
}

// Workspace (int32 words): [0, 2) the work counters, then cnt [Kd * P],
// items [Kd * P], cnt_sub [Kd * P * kMaxSub], list_m [Kd * P * Q], list_r
// (uint16) [Kd * P * Q].
template <typename T>
int launch(const void* F, int Cin, const void* m, int M, int Kd,
           const void* g, int Cout, int Q, int mi, int ni, void* ws,
           void* partial, void* out, void* stream) {
  if (Q != kPanel) return cudaErrorInvalidValue;
  if (Kd <= 0 || Cin <= 0 || Cout <= 0) return cudaSuccess;
  const int sub_rows = pack_rows(Kd);
  if (sub_rows == 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = M > 0 ? (M + Q - 1) / Q : 0;
  const int per_k = Cin * Cout;
  const int64_t kp = static_cast<int64_t>(Kd) * P;
  int32_t* ctr = static_cast<int32_t*>(ws);
  int32_t* cnt = ctr + 2;
  int32_t* items = cnt + kp;
  int32_t* cnt_sub = items + kp;
  int32_t* list_m = cnt_sub + kp * kMaxSub;
  uint16_t* list_r = reinterpret_cast<uint16_t*>(list_m + kp * Q);
  if (P > 0) {
    static bool configured = false;   // above 48 KB needs the opt-in
    if (!configured) {
      const cudaError_t e = cudaFuncSetAttribute(
          dw_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kPackSmem);
      if (e != cudaSuccess) return e;
      configured = true;
    }
    cudaError_t e = cudaMemsetAsync(ctr, 0, (2 + kp) * sizeof(int32_t), s);
    if (e != cudaSuccess) return e;
    const int n_sub = kPanel / sub_rows;
    dw_pack_kernel<<<P * n_sub, kPackThreads, sub_rows * Kd * 4, s>>>(
        static_cast<const int32_t*>(m), M, Kd, P, sub_rows, n_sub, list_m,
        list_r, cnt_sub, cnt, items, ctr);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    int shift = 0;
    while ((1 << shift) < sub_rows) ++shift;
    const Lists l{list_m, list_r, cnt_sub, n_sub, shift, cnt, items, ctr};
    e = static_cast<cudaError_t>(
        launch_tile<T>(mi, ni, F, Cin, g, Cout, Kd, P, l, partial, s));
    if (e != cudaSuccess) return e;
  }
  const int64_t elems = static_cast<int64_t>(Kd) * per_k;
  const unsigned blocks =
      static_cast<unsigned>((elems + kCombineThreads - 1) / kCombineThreads);
  dw_combine_kernel<<<blocks, kCombineThreads, 0, s>>>(
      static_cast<const float*>(partial), cnt, Kd, P, per_k,
      static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// F: [N, Cin]; m: int32 [M, Kd]; g: [M, Cout] (F and g of one type, fp32
// or bf16); Q: panel rows (4096); mi, ni: the Cin x Cout tile in units of
// 32 (1..3 each, from the wrapper's _tile_for); ws: int32 workspace of
// 2 + Kd * P * (2 + Q / 32 + Q) + ceil(Kd * P * Q / 2) words, P =
// ceil(M / Q);
// partial: fp32 scratch [Kd * P, Cin, Cout]; out: fp32 [Kd, Cin, Cout].
// All contiguous.
extern "C" int spira_dw_gather_gemm_f32(
    const void* F, int Cin, const void* m, int M, int Kd, const void* g,
    int Cout, int Q, int mi, int ni, void* ws, void* partial, void* out,
    void* stream) {
  return launch<float>(F, Cin, m, M, Kd, g, Cout, Q, mi, ni, ws, partial,
                       out, stream);
}

extern "C" int spira_dw_gather_gemm_bf16(
    const void* F, int Cin, const void* m, int M, int Kd, const void* g,
    int Cout, int Q, int mi, int ni, void* ws, void* partial, void* out,
    void* stream) {
  return launch<__nv_bfloat16>(F, Cin, m, M, Kd, g, Cout, Q, mi, ni, ws,
                               partial, out, stream);
}
