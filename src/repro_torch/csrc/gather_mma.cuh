// The gather-GEMM sweep shared by the OS implicit GEMM
// (spconv_gather_gemm.cu) and the WS sweep (ws_scatter_gemm.cu): a block
// owns 128 output rows by a Cout tile BN, holds their fp32 sums in shared
// memory, and walks the offsets in order, 16 at a time. Per chunk the
// caller fills, for each offset, the packed list of the tile's rows that
// use it (row order) and their input rows; run_chunk then runs K-steps
// over (offset with rows, pass of up to 64 packed rows, Cin slice of 128
// bytes) in a 2-stage cp.async pipeline and adds each pass's sum to its
// rows' accumulators once. What the two kernels differ in is only how the
// packed lists are made: the OS kernel compacts the staged map by ballots,
// the WS sweep reads the pack kernel's per-panel lists (cut to a
// capacity).
//
//  * Copies are 16 bytes where a row's bytes (Cin or Cout times the element
//    size) and the base allow it, else 8 or 4; a bf16 row of odd length is
//    copied by 2-byte loads. Rows past the pass's count, up to the
//    fragment, are zero-filled (src-size 0), as are the channels between
//    Cin and the mma depth (8 for tf32, 16 for bf16).
//  * Fragments: A (packed rows) by ldmatrix.x4 from 144-byte padded rows;
//    bf16 B by ldmatrix.x4.trans; tf32 B by 32-bit shared loads (ldmatrix
//    moves 16-bit elements and cannot transpose 32-bit ones) from rows
//    padded by 8 words. The padding keeps every access bank-conflict free.
//  * Each 16 packed rows by 16 columns of a pass is a unit of work; unit u
//    falls to warp u % 8.
//  * bf16: mma.m16n8k16 with fp32 accumulators; the products are exact.
//  * fp32: 3xTF32 on mma.m16n8k8. Each operand splits into hi =
//    rna_tf32(x) and lo = rna_tf32(x - hi), and each fragment accumulates
//    a_lo.b_hi, then a_hi.b_lo, then a_hi.b_hi (the two column fragments
//    of a unit interleave). hi + lo carries 22 of x's 24 significant bits,
//    and the dropped a_lo.b_lo term is below 2^-22 of the product. The
//    tensor cores' own accumulate truncates instead of rounding, so each 16
//    channels sum into a zeroed fragment and are added to the offset's sum
//    by one fp32 add (round to nearest).
//
// Add order: every output element has one fp32 accumulator, +0.0 at the
// start. For each offset in order, the element's products are summed over
// the Cin slices in order (each slice a fixed sequence of mma
// instructions; in fp32 each 16 channels summed apart, then added), and
// that sum is added to the accumulator once. A sum depends only on the
// element's own input row and W: where the row sits among the packed rows
// changes no arithmetic.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace spira_gm {

using namespace spira_tc;

constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 128;         // rows per block
constexpr int kPass = 64;        // packed rows per K-step (a pass)
constexpr int kSliceBytes = 128; // bytes of a row per K-step
constexpr int kLdA = kSliceBytes + 16;  // padded A row (bank-conflict free)
constexpr int kStages = 2;
constexpr int kKC = 16;          // offsets per chunk

template <typename T> struct Mma;
template <> struct Mma<float> {
  static constexpr int kBK = 32;     // channels per K-step
  static constexpr int kDepth = 8;   // m16n8k8 tf32
  static constexpr int kPadB = 32;   // 8 words: conflict-free 32-bit loads
};
template <> struct Mma<__nv_bfloat16> {
  static constexpr int kBK = 64;
  static constexpr int kDepth = 16;  // m16n8k16 bf16
  static constexpr int kPadB = 16;   // conflict-free ldmatrix.trans
};

// A pipeline stage: A, up to 64 packed input rows of one Cin slice; B,
// W[k]'s slice [kBK][BN].
template <typename T, int BN> struct Stage {
  static constexpr int kUnits = BN / 16;   // 16-column units of a row group
  // units of a pass that fall to one warp, at most
  static constexpr int kMine = (kPass / 16 * kUnits + kWarps - 1) / kWarps;
  static constexpr int kLdB = BN * static_cast<int>(sizeof(T)) + Mma<T>::kPadB;
  static constexpr int kABytes = kPass * kLdA;
  static constexpr int kBytes = kABytes + Mma<T>::kBK * kLdB;
};

// Shared memory of a block: the pipeline's stages, the fp32 accumulators
// [128][BN + 8], the packed input rows of a chunk's offsets [16][128 + 1],
// their rows in the tile (uint8) and the chunk's lists: rows per offset,
// the offsets with rows and their counts, the step count.
template <typename T, int BN> struct Tile {
  static constexpr int kLdAcc = BN + 8;    // floats: conflict-free float2
  static constexpr int kLdIdx = kBM + 1;   // conflict-free stores
  static constexpr int kAccOffset = kStages * Stage<T, BN>::kBytes;
  static constexpr int kMapOffset = kAccOffset + kBM * kLdAcc * 4;
  static constexpr int kRowsOffset = kMapOffset + kKC * kLdIdx * 4;
  static constexpr int kListOffset = kRowsOffset + kKC * kBM;
  static constexpr int kSmem = kListOffset + (3 * kKC + 1) * 4;
};

// A K-step: active offset a, pass rp over its packed rows (64 at a time),
// Cin slice cs; `next` walks them in order without division.
struct Step {
  int a, rp, cs;
  __device__ __forceinline__ void next(const int* act_cnt, int n_slices) {
    if (++cs < n_slices) return;
    cs = 0;
    if (++rp * kPass < act_cnt[a]) return;
    rp = 0;
    ++a;
  }
};

// Issue the copies of one K-step: the inputs js[0..cnt) of a pass's rows
// at channels [c0, c0 + nch), packed into A rows 0..cnt with zeros up to
// the next multiple of 16; and rows [c0, c0 + nch) x columns [n0, n0 + BN)
// of wk = W[k].
template <typename T, int BN>
__device__ __forceinline__ void load_step(char* stage, const T* F, int Cin,
                                          const int* js, int cnt,
                                          const T* wk, int Cout, int c0,
                                          int nch, int n0, int vecA,
                                          const Walk& wb) {
  using S = Stage<T, BN>;
  constexpr int kSize = sizeof(T);
  const int per_a = vecA / kSize;
  // chunks per row, rounded up to a power of two (extra ones zero-fill)
  const int shift = 32 - __clz(nch / per_a - 1);
  const int n_rows = (cnt + 15) & ~15;
  for (int e = threadIdx.x; e < (n_rows << shift); e += kThreads) {
    const int p = e >> shift;
    const int c = (e & ((1 << shift) - 1)) * per_a;
    const bool ok = p < cnt && c0 + c < Cin;
    const T* src = ok ? F + static_cast<int64_t>(js[p]) * Cin + c0 + c : F;
    copy_chunk(stage + p * kLdA + c * kSize,
               reinterpret_cast<const char*>(src), ok, vecA);
  }
  char* bs = stage + S::kABytes;
  const int per_b = BN / wb.chunks;     // elements per copy
  for (int r = wb.r0, q = wb.c0; r < nch;) {
    const int c = q * per_b;
    const bool ok = c0 + r < Cin && n0 + c < Cout;
    const T* src = ok ? wk + static_cast<int64_t>(c0 + r) * Cout + n0 + c
                      : wk;
    copy_chunk(bs + r * S::kLdB + c * kSize,
               reinterpret_cast<const char*>(src), ok, per_b * kSize);
    r += wb.dr;
    q += wb.dc;
    if (q >= wb.chunks) {
      q -= wb.chunks;
      ++r;
    }
  }
}

// The units of one K-step that fall to this warp (unit u = warp + 8 i: row
// group u / kUnits of the pass's packed rows, 16 columns from
// 16 (u % kUnits)): `nks` mma depths of the slice into the units'
// fragments `pk`.
template <int BN>
__device__ __forceinline__ void mma_step(
    const char* stage, int nks, int n_mine, int warp, int lane,
    float (&pk)[Stage<__nv_bfloat16, BN>::kMine][2][4], __nv_bfloat16) {
  using S = Stage<__nv_bfloat16, BN>;
  const char* bs = stage + S::kABytes;
#pragma unroll
  for (int ui = 0; ui < S::kMine; ++ui) {
    if (ui >= n_mine) break;
    const int u = warp + kWarps * ui;
    const int grp = u / S::kUnits;
    const int cu = u - grp * S::kUnits;
    const int row = grp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int krow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int col = cu * 16 + (lane >> 4) * 8;
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, smem_u32(stage + row * kLdA +
                              (ks * 2 + (lane >> 4)) * 16));
      ldmatrix_x4_trans(b, smem_u32(bs + (ks * 16 + krow) * S::kLdB +
                                    col * 2));
      mma_bf16(pk[ui][0], a, b[0], b[1]);
      mma_bf16(pk[ui][1], a, b[2], b[3]);
    }
  }
}

template <int BN>
__device__ __forceinline__ void mma_step(
    const char* stage, int nks, int n_mine, int warp, int lane,
    float (&pk)[Stage<float, BN>::kMine][2][4], float) {
  using S = Stage<float, BN>;
  constexpr int kLdBw = S::kLdB / 4;
  const float* bs = reinterpret_cast<const float*>(stage + S::kABytes);
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int ui = 0; ui < S::kMine; ++ui) {
    if (ui >= n_mine) break;
    const int u = warp + kWarps * ui;
    const int grp = u / S::kUnits;
    const int cu = u - grp * S::kUnits;
    const int row = grp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    float part[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t raw[4], ah[4], al[4], bh[2][2], bl[2][2];
      ldmatrix_x4(raw, smem_u32(stage + row * kLdA +
                                (ks * 2 + (lane >> 4)) * 16));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tf32_split(__uint_as_float(raw[i]), ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = cu * 16 + j * 8 + g;
        tf32_split(bs[(ks * 8 + t) * kLdBw + col], bh[j][0], bl[j][0]);
        tf32_split(bs[(ks * 8 + t + 4) * kLdBw + col], bh[j][1], bl[j][1]);
      }
      // each fragment takes a_lo.b_hi, then a_hi.b_lo, then a_hi.b_hi
#pragma unroll
      for (int j = 0; j < 2; ++j) mma_tf32(part[j], al, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < 2; ++j) mma_tf32(part[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < 2; ++j) mma_tf32(part[j], ah, bh[j][0], bh[j][1]);
      if ((ks & 1) || ks + 1 == nks) {  // every 16 channels, round to nearest
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pk[ui][j][i] += part[j][i];
            part[j][i] = 0.0f;
          }
      }
    }
  }
}

// Zero the block's accumulators.
template <typename T, int BN>
__device__ __forceinline__ void clear_acc(char* smem) {
  using L = Tile<T, BN>;
  float* acc_s = reinterpret_cast<float*>(smem + L::kAccOffset);
  for (int e = threadIdx.x; e < kBM * L::kLdAcc; e += kThreads)
    acc_s[e] = 0.0f;
}

// One chunk of kcn offsets, whose packed lists the caller has written
// (count per offset in the list area, packed input rows at row i of offset
// kk's map row, their rows in the tile likewise): the K-steps of every
// offset with rows, each pass's sums added to its rows' accumulators.
// wc = W of the chunk's first offset. Returns with no copy in flight.
template <typename T, int BN>
__device__ __forceinline__ void run_chunk(char* smem, const T* F, int Cin,
                                          const T* wc, int Cout, int kcn,
                                          int n0, int vecA, const Walk& wb) {
  using L = Tile<T, BN>;
  using S = Stage<T, BN>;
  constexpr int kBK = Mma<T>::kBK;
  constexpr int kDepth = Mma<T>::kDepth;
  float* acc_s = reinterpret_cast<float*>(smem + L::kAccOffset);
  const int* idx_s = reinterpret_cast<const int*>(smem + L::kMapOffset);
  const uint8_t* rows_s = reinterpret_cast<const uint8_t*>(smem +
                                                           L::kRowsOffset);
  int* cnt_s = reinterpret_cast<int*>(smem + L::kListOffset);   // [kKC]
  int* act_s = cnt_s + kKC;      // [kKC] offsets with rows, in order
  int* act_cnt_s = act_s + kKC;  // [kKC] their row counts
  int* n_steps_s = act_cnt_s + kKC;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_slices = (Cin + kBK - 1) / kBK;
  __syncthreads();             // the chunk's lists are written
  if (threadIdx.x == 0) {
    int n = 0, steps = 0;
    for (int kk = 0; kk < kcn; ++kk)
      if (cnt_s[kk]) {
        act_cnt_s[n] = cnt_s[kk];
        act_s[n++] = kk;
        steps += (cnt_s[kk] + kPass - 1) / kPass * n_slices;
      }
    *n_steps_s = steps;
  }
  __syncthreads();
  const int n_steps = *n_steps_s;

  float pk[S::kMine][2][4];
#pragma unroll
  for (int ui = 0; ui < S::kMine; ++ui)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) pk[ui][j][i] = 0.0f;

  Step is{0, 0, 0};          // the next step to issue
  Step cs{0, 0, 0};          // the step to multiply
  auto issue = [&](int s) {
    const int c0 = is.cs * kBK;
    const int kk = act_s[is.a];
    const int nch = min(kBK, (Cin - c0 + kDepth - 1) / kDepth * kDepth);
    load_step<T, BN>(smem + (s % kStages) * S::kBytes, F, Cin,
                     idx_s + kk * L::kLdIdx + is.rp * kPass,
                     min(kPass, act_cnt_s[is.a] - is.rp * kPass),
                     wc + static_cast<int64_t>(kk) * Cin * Cout, Cout, c0,
                     nch, n0, vecA, wb);
    is.next(act_cnt_s, n_slices);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();           // step s landed; step s - 1's reads are done
    if (s + kStages - 1 < n_steps) issue(s + kStages - 1);
    cp_async_commit();
    const int cnt = min(kPass, act_cnt_s[cs.a] - cs.rp * kPass);
    const int n_units = ((cnt + 15) >> 4) * S::kUnits;
    const int n_mine = (n_units - warp + kWarps - 1) / kWarps;
    const int c0 = cs.cs * kBK;
    const int nks = min(kBK, (Cin - c0 + kDepth - 1) / kDepth * kDepth) /
                    kDepth;
    mma_step<BN>(smem + (s % kStages) * S::kBytes, nks, n_mine, warp, lane,
                 pk, T());
    if (cs.cs == n_slices - 1) {
      // the pass's sums into its rows' accumulators, one add each
      const uint8_t* rows = rows_s + act_s[cs.a] * kBM + cs.rp * kPass;
#pragma unroll
      for (int ui = 0; ui < S::kMine; ++ui) {
        if (ui >= n_mine) break;
        const int u = warp + kWarps * ui;
        const int grp = u / S::kUnits;
        const int cu = u - grp * S::kUnits;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = grp * 16 + g + 8 * h;
          if (p >= cnt) continue;
          float* dst = acc_s + rows[p] * L::kLdAcc + cu * 16 + 2 * t;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float2 v = *reinterpret_cast<float2*>(dst + j * 8);
            v.x += pk[ui][j][2 * h];
            v.y += pk[ui][j][2 * h + 1];
            *reinterpret_cast<float2*>(dst + j * 8) = v;
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) pk[ui][j][i] = 0.0f;
      }
    }
    cs.next(act_cnt_s, n_slices);
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Write the block's accumulators, rows [row0, row0 + 128) by columns
// [n0, n0 + BN) cut to M and Cout, once, in the output's type.
template <typename T, int BN, typename Out>
__device__ __forceinline__ void store_tile(const char* smem, Out* out,
                                           int row0, int M, int n0,
                                           int Cout) {
  using L = Tile<T, BN>;
  const float* acc_s = reinterpret_cast<const float*>(smem + L::kAccOffset);
  __syncthreads();
  for (int e = threadIdx.x; e < kBM * BN; e += kThreads) {
    const int r = e / BN;
    const int c = e - r * BN;
    if (row0 + r < M && n0 + c < Cout)
      store(out + static_cast<int64_t>(row0 + r) * Cout + n0 + c,
            acc_s[r * L::kLdAcc + c]);
  }
}

}  // namespace spira_gm
