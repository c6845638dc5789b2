// Output-stationary implicit-GEMM sparse convolution for Hopper:
//   out[i] = sum_k 1[m[i,k] >= 0] * F[m[i,k]] @ W[k]
//
// Replaces the TPU kernel repro/kernels/spconv_gather_gemm.py::
// spconv_gather_gemm (_kernel). As there, the kernel-map gather happens
// inside the kernel: no [M, Kd, Cin] gathered tensor ever exists in device
// memory.
//
// What bounds it on this card: operations for the wide layers (2 * nnz *
// Cin * Cout useful), the gather's bytes for the stem, and at full
// resolution the reads of W: a 128-row tile there uses almost every one of
// the 27 offsets while each row uses a few, so every tile reads all of W
// for a few rows per offset. The first version ran a 4x4 fp32 FMA loop on the
// CUDA cores, bound by its shared-memory reads at ~2.2 TFLOP/s. This one
// runs on the tensor cores through mma.sync:
//
//  * Block: 8 warps, a tile of 128 rows by a Cout tile BN of 32, 64 or 96
//    (chosen by the wrapper's _tile_for from Cin, Cout and the dtype,
//    never from M). Its fp32 accumulators live in shared memory,
//    [128][BN + 8].
//  * Per chunk of 16 offsets the block stages its 128 x 16 map entries in
//    shared memory and packs, for each offset, the rows of the tile that
//    use it (in row order) with their input rows. An offset no row uses
//    issues no copy and no mma; an offset used by c rows runs ceil(c / 16)
//    16-row mma fragments instead of 8. At full resolution that is 2.1x
//    the useful products against 12.8x for the whole tile (MinkUNet-42's
//    outdoor scenes). Each fragment's 16 columns are a unit of work, and
//    unit u falls to warp u % 8.
//  * K-steps run over (active offset, pass of up to 64 packed rows, Cin
//    slice of 128 bytes: 64 bf16 or 32 fp32) in a 2-stage cp.async
//    pipeline: the pass's input rows and W[k]'s slice of step s + 1 load
//    while step s multiplies. At full resolution a step has a few rows
//    and its time is the latency of those loads, so the design keeps steps
//    few and wide and two blocks on an SM (the 64-row pass, 2 stages and
//    16-offset chunks keep a 96-column block at 106 KB of shared memory).
//    Copies are 16 bytes where a row's bytes (Cin or Cout times the
//    element size) and the base allow it, else 8 or 4; a bf16 row of odd
//    length is copied by 2-byte loads. Rows past the pass's count, up to
//    the fragment, are zero-filled (src-size 0), as are the channels
//    between Cin and the mma depth (8 for tf32, 16 for bf16). The loops
//    count steps and copies without integer division.
//  * Fragments: A (packed rows) by ldmatrix.x4 from 80-byte padded rows;
//    bf16 B by ldmatrix.x4.trans; tf32 B by 32-bit shared loads (ldmatrix
//    moves 16-bit elements and cannot transpose 32-bit ones) from rows
//    padded by 8 words. The padding keeps every access bank-conflict free.
//  * bf16: mma.m16n8k16 with fp32 accumulators; the products are exact.
//  * fp32: 3xTF32 on mma.m16n8k8. Each operand splits into hi =
//    rna_tf32(x) and lo = rna_tf32(x - hi), and each fragment accumulates
//    a_lo.b_hi, then a_hi.b_lo, then a_hi.b_hi (the two column fragments
//    of a unit interleave). hi + lo carries 22 of x's 24 significant bits,
//    and the dropped a_lo.b_lo term is below 2^-22 of the product. The
//    tensor cores' own accumulate truncates instead of rounding, which
//    over the ~1,000 mma of a Kd = 125 layer drifts by ~1e-5 relative, so
//    each 16 channels sum into a zeroed fragment there and are added to
//    the offset's sum by one fp32 add (round to nearest). The sums keep the
//    accuracy of an fp32 sum (chip_smoke holds every fp32 launch against a
//    float64 reference) at a third of the TF32 rate. Plain TF32 would keep
//    ~3 decimal digits and break the IEEE-fp32 reference contract.
//
// Add order: every output element has one fp32 accumulator. For each
// offset in order, the element's products are summed over the Cin slices
// in order (each slice a fixed sequence of mma instructions; in fp32 each
// 16 channels summed apart, then added), and that sum is added to the
// accumulator once. A sum depends only on the element's own input row
// and W: where the row sits among the packed rows changes no arithmetic.
// The tile shape does not depend on M, so a row's bits depend on nothing
// but its own map row: a batch of B is bitwise equal to B single runs. No
// split-K, no atomics. The output is written in the input's type.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

using namespace spira_tc;

constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 128;         // rows per block
constexpr int kPass = 64;        // packed rows per K-step (a pass)
constexpr int kSliceBytes = 128; // bytes of a row per K-step
constexpr int kLdA = kSliceBytes + 16;  // padded A row (bank-conflict free)
constexpr int kStages = 2;
constexpr int kKC = 16;          // offsets per staged map chunk
constexpr int kLdIdx = kBM + 1;  // staged map row: conflict-free stores

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

// Shared memory of a block: the pipeline's stages (A: up to 64 packed
// input rows, B: W[k]'s slice), the fp32 accumulators [128][BN + 8], the
// staged map [16 offsets][128 rows] (packed in place into the inputs of
// the rows that use each offset), those rows (uint8), and the list of
// offsets in use with their row counts.
template <typename T, int BN> struct Tile {
  static constexpr int kUnits = BN / 16;   // 16-column units of a row group
  static constexpr int kLdB = BN * static_cast<int>(sizeof(T)) + Mma<T>::kPadB;
  static constexpr int kABytes = kPass * kLdA;
  static constexpr int kStageBytes = kABytes + Mma<T>::kBK * kLdB;
  static constexpr int kLdAcc = BN + 8;    // floats: conflict-free float2
  static constexpr int kAccOffset = kStages * kStageBytes;
  static constexpr int kMapOffset = kAccOffset + kBM * kLdAcc * 4;
  static constexpr int kRowsOffset = kMapOffset + kKC * kLdIdx * 4;
  static constexpr int kListOffset = kRowsOffset + kKC * kBM;
  static constexpr int kSmem = kListOffset + 3 * kKC * 4;
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
  char* bs = stage + Tile<T, BN>::kABytes;
  const int per_b = BN / wb.chunks;     // elements per copy
  for (int r = wb.r0, q = wb.c0; r < nch;) {
    const int c = q * per_b;
    const bool ok = c0 + r < Cin && n0 + c < Cout;
    const T* src = ok ? wk + static_cast<int64_t>(c0 + r) * Cout + n0 + c
                      : wk;
    copy_chunk(bs + r * Tile<T, BN>::kLdB + c * kSize,
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
__device__ __forceinline__ void mma_step(const char* stage, int nks,
                                         int n_mine, int warp, int lane,
                                         float (&pk)[BN / 32][2][4],
                                         __nv_bfloat16) {
  constexpr int kUnits = BN / 16;
  const char* bs = stage + Tile<__nv_bfloat16, BN>::kABytes;
#pragma unroll
  for (int ui = 0; ui < kUnits / 2; ++ui) {
    if (ui >= n_mine) break;
    const int u = warp + kWarps * ui;
    const int grp = u / kUnits;
    const int cu = u - grp * kUnits;
    const int row = grp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int krow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int col = cu * 16 + (lane >> 4) * 8;
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, smem_u32(stage + row * kLdA +
                              (ks * 2 + (lane >> 4)) * 16));
      ldmatrix_x4_trans(b, smem_u32(bs + (ks * 16 + krow) *
                                             Tile<__nv_bfloat16, BN>::kLdB +
                                         col * 2));
      mma_bf16(pk[ui][0], a, b[0], b[1]);
      mma_bf16(pk[ui][1], a, b[2], b[3]);
    }
  }
}

template <int BN>
__device__ __forceinline__ void mma_step(const char* stage, int nks,
                                         int n_mine, int warp, int lane,
                                         float (&pk)[BN / 32][2][4], float) {
  constexpr int kUnits = BN / 16;
  constexpr int kLdBw = Tile<float, BN>::kLdB / 4;
  const float* bs =
      reinterpret_cast<const float*>(stage + Tile<float, BN>::kABytes);
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int ui = 0; ui < kUnits / 2; ++ui) {
    if (ui >= n_mine) break;
    const int u = warp + kWarps * ui;
    const int grp = u / kUnits;
    const int cu = u - grp * kUnits;
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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
os_mma_kernel(const T* __restrict__ F, int Cin,
              const int32_t* __restrict__ m, int M, int Kd,
              const T* __restrict__ W, int Cout, T* __restrict__ out,
              int n_col_tiles, int vecA, int vecB) {
  using L = Tile<T, BN>;
  constexpr int kBK = Mma<T>::kBK;
  constexpr int kDepth = Mma<T>::kDepth;
  constexpr int kUnits = L::kUnits;
  extern __shared__ __align__(16) char smem[];
  float* acc_s = reinterpret_cast<float*>(smem + L::kAccOffset);
  int* idx_s = reinterpret_cast<int*>(smem + L::kMapOffset);  // [kKC][kLdIdx]
  uint8_t* rows_s = reinterpret_cast<uint8_t*>(smem + L::kRowsOffset);
  int* cnt_s = reinterpret_cast<int*>(smem + L::kListOffset);  // [kKC]
  int* act_s = cnt_s + kKC;      // [kKC] offsets some row uses, in order
  int* act_cnt_s = act_s + kKC;  // [kKC] their row counts
  __shared__ int n_steps_s;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = (blockIdx.x / n_col_tiles) * kBM;
  const int n0 = (blockIdx.x % n_col_tiles) * BN;
  const int n_slices = (Cin + kBK - 1) / kBK;
  const Walk wb =
      make_walk<kThreads>(BN * static_cast<int>(sizeof(T)) / vecB);

  for (int e = threadIdx.x; e < kBM * L::kLdAcc; e += kThreads)
    acc_s[e] = 0.0f;
  float pk[kUnits / 2][2][4];
#pragma unroll
  for (int ui = 0; ui < kUnits / 2; ++ui)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) pk[ui][j][i] = 0.0f;

  for (int kc0 = 0; kc0 < Kd; kc0 += kKC) {
    const int kcn = min(kKC, Kd - kc0);
    __syncthreads();           // the last chunk's map and lists are done with
    {
      const int r = threadIdx.x % kBM;
      const int row = row0 + r;
      const int32_t* mr = m + static_cast<int64_t>(row) * Kd + kc0;
      for (int kk = threadIdx.x / kBM; kk < kcn; kk += kThreads / kBM)
        idx_s[kk * kLdIdx + r] = row < M ? mr[kk] : -1;
    }
    __syncthreads();
    // per offset, the tile rows that use it and their inputs, packed in
    // row order (in place: a row's packed position is never past it)
    for (int kk = warp; kk < kcn; kk += kWarps) {
      int* col = idx_s + kk * kLdIdx;
      int n = 0;
#pragma unroll
      for (int j = 0; j < kBM / 32; ++j) {
        const int r = lane + 32 * j;
        const int v = col[r];
        const unsigned b = __ballot_sync(0xffffffffu, v >= 0);
        if (v >= 0) {
          const int p = n + __popc(b & ((1u << lane) - 1u));
          col[p] = v;
          rows_s[kk * kBM + p] = static_cast<uint8_t>(r);
        }
        n += __popc(b);
      }
      if (lane == 0) cnt_s[kk] = n;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int n = 0, steps = 0;
      for (int kk = 0; kk < kcn; ++kk)
        if (cnt_s[kk]) {
          act_cnt_s[n] = cnt_s[kk];
          act_s[n++] = kk;
          steps += (cnt_s[kk] + kPass - 1) / kPass * n_slices;
        }
      n_steps_s = steps;
    }
    __syncthreads();
    const int n_steps = n_steps_s;

    Step is{0, 0, 0};          // the next step to issue
    Step cs{0, 0, 0};          // the step to multiply
    auto issue = [&](int s) {
      const int c0 = is.cs * kBK;
      const int kk = act_s[is.a];
      const int nch = min(kBK, (Cin - c0 + kDepth - 1) / kDepth * kDepth);
      load_step<T, BN>(smem + (s % kStages) * L::kStageBytes, F, Cin,
                       idx_s + kk * kLdIdx + is.rp * kPass,
                       min(kPass, act_cnt_s[is.a] - is.rp * kPass),
                       W + static_cast<int64_t>(kc0 + kk) * Cin * Cout, Cout,
                       c0, nch, n0, vecA, wb);
      is.next(act_cnt_s, n_slices);
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_steps) issue(s);
      cp_async_commit();
    }
    for (int s = 0; s < n_steps; ++s) {
      cp_async_wait<kStages - 2>();
      __syncthreads();         // step s landed; step s - 1's reads are done
      if (s + kStages - 1 < n_steps) issue(s + kStages - 1);
      cp_async_commit();
      const int cnt = min(kPass, act_cnt_s[cs.a] - cs.rp * kPass);
      const int n_units = ((cnt + 15) >> 4) * kUnits;
      const int n_mine = (n_units - warp + kWarps - 1) / kWarps;
      const int c0 = cs.cs * kBK;
      const int nks = min(kBK, (Cin - c0 + kDepth - 1) / kDepth * kDepth) /
                      kDepth;
      mma_step<BN>(smem + (s % kStages) * L::kStageBytes, nks, n_mine, warp,
                   lane, pk, T());
      if (cs.cs == n_slices - 1) {
        // the pass's sums into its rows' accumulators, one add each
        const uint8_t* rows = rows_s + act_s[cs.a] * kBM + cs.rp * kPass;
#pragma unroll
        for (int ui = 0; ui < kUnits / 2; ++ui) {
          if (ui >= n_mine) break;
          const int u = warp + kWarps * ui;
          const int grp = u / kUnits;
          const int cu = u - grp * kUnits;
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

  __syncthreads();
  for (int e = threadIdx.x; e < kBM * BN; e += kThreads) {
    const int r = e / BN;
    const int c = e - r * BN;
    if (row0 + r < M && n0 + c < Cout)
      store(out + static_cast<int64_t>(row0 + r) * Cout + n0 + c,
            acc_s[r * L::kLdAcc + c]);
  }
}

template <typename T, int BN>
int launch_bn(const void* F, int Cin, const void* m, int M, int Kd,
              const void* W, int Cout, void* out, cudaStream_t s) {
  auto kernel = os_mma_kernel<T, BN>;
  constexpr int bytes = Tile<T, BN>::kSmem;
  static bool configured = false;    // above 48 KB needs the opt-in
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int n_col = (Cout + BN - 1) / BN;
  const int64_t blocks = static_cast<int64_t>((M + kBM - 1) / kBM) * n_col;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  constexpr int kSize = sizeof(T);
  const int vecA = copy_bytes(F, static_cast<int64_t>(Cin) * kSize, kSize);
  const int vecB = copy_bytes(W, static_cast<int64_t>(Cout) * kSize, kSize);
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(
      static_cast<const T*>(F), Cin, static_cast<const int32_t*>(m), M, Kd,
      static_cast<const T*>(W), Cout, static_cast<T*>(out), n_col, vecA,
      vecB);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* F, int Cin, const void* m, int M, int Kd,
           const void* W, int Cout, void* out, int bn, void* stream) {
  if (M <= 0 || Cout <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 32:
      return launch_bn<T, 32>(F, Cin, m, M, Kd, W, Cout, out, s);
    case 64:
      return launch_bn<T, 64>(F, Cin, m, M, Kd, W, Cout, out, s);
    case 96:
      return launch_bn<T, 96>(F, Cin, m, M, Kd, W, Cout, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// F: [N, Cin]; m: int32 [M, Kd]; W: [Kd, Cin, Cout]; out: [M, Cout]; all
// contiguous, F / W / out of one type (fp32 or bf16); bn the Cout tile
// (32, 64 or 96, from the wrapper's _tile_for).
extern "C" int spira_spconv_gather_gemm_f32(
    const void* F, int Cin, const void* m, int M, int Kd, const void* W,
    int Cout, void* out, int bn, void* stream) {
  return launch<float>(F, Cin, m, M, Kd, W, Cout, out, bn, stream);
}

extern "C" int spira_spconv_gather_gemm_bf16(
    const void* F, int Cin, const void* m, int M, int Kd, const void* W,
    int Cout, void* out, int bn, void* stream) {
  return launch<__nv_bfloat16>(F, Cin, m, M, Kd, W, Cout, out, bn, stream);
}
