// Masked grouped GEMM over a pre-gathered tensor, for Hopper:
//   out[i] = sum_k 1[m[i,k] >= 0] * g[i,k] @ W[k]
//
// Replaces the TPU kernel repro/kernels/masked_group_gemm.py::
// masked_group_gemm (_kernel): the unfused output-stationary baseline,
// whose caller has already gathered g[i, k, :] = F[max(m[i,k], 0)] into an
// [M, Kd, Cin] tensor in device memory. The TPU kernel walks Kd on a
// sequential grid axis with the output tile resident in VMEM.
//
// What bounds it on this card: the first version ran a 4 x 4 fp32 fmaf
// tile on the CUDA cores over every dense product (2 * M * Kd * Cin * Cout:
// 130 GFLOP for a full-resolution 96 -> 96 layer, ~1.9 ms at fp32's 67
// TFLOP/s against 0.81 ms for its 2.7 GB of g), so it was bound by
// operations and lost to one torch.einsum. This one is a streaming GEMM on
// the tensor cores. Its bound is g's bytes; on MinkUNet-42's layers it
// runs at about 2.4x that, held by its fragment loop (ldmatrix, the mask
// lookups and vote, the 3xTF32 splits per mma), not by the bytes:
//
//  * The product is one GEMM: A = g as [M, Kd * Cin] (row-major and
//    contiguous) times B = W as [Kd * Cin, Cout]; a flat column c of A is
//    channel c % Cin of offset c / Cin. A block of 8 warps (4 along rows x
//    2 along Cout) owns 128 rows by a Cout tile BN of 32, 64, 96 or 128
//    (the wrapper's _tile_for, from Cout alone), so each byte of g is read
//    once (twice for Cout 256, whose two tiles run side by side and share
//    it through L2). Its fp32 sums stay in registers.
//  * The block's map tile [128, Kd] is loaded once, as a uint8 mask.
//  * A and W stream in slices of 128 bytes of flat columns (32 fp32 or
//    64 bf16) through a ring of stages: A's 128 rows by the slice, W's slice
//    rows by BN, and the slice's column -> offset table. Where g's and W's
//    row pitches are multiples of 16 bytes (every MinkUNet layer), one
//    thread loads a slice by TMA: a 2-D tensor map over g as
//    [M, Kd * Cin] and one over W as [Kd * Cin, Cout] (encoded per launch
//    through cudaGetDriverEntryPoint, so nothing new is linked), boxes of
//    128 bytes by 128 (A) or kBK (W) rows in the 128-byte swizzle, an
//    mbarrier per stage; rows past M and columns past Kd * Cin or Cout
//    land as zeros. Issuing the same slice as per-thread 16-byte cp.async
//    cost as many cycles as its mma on the 96 -> 96 layers (clock64
//    counters on the card). Other pitches take a cp.async ring: 16, 8 or 4
//    byte copies as the pitch and base allow (2-byte loads for an odd
//    bf16 pitch), zero-filled past the edges.
//  * Fragments: A by ldmatrix.x4 (swizzled rows, or rows padded by 16
//    bytes), then each element multiplied in registers by its row's mask
//    for its column's offset: a multiply, never a select, so an inf or NaN
//    at a masked position still makes the row NaN, as in the TPU kernel.
//    bf16 B by ldmatrix.x4.trans; fp32 B by 32-bit shared loads.
//  * A 16-row fragment whose rows all have mask 0 over a k8 (k16) step,
//    and whose values there are all finite, adds nothing but zeros
//    (0 * x = +-0 for finite x): its mma are skipped, by one vote; any
//    non-finite value runs the multiply. PAD rows and offsets no row of a
//    fragment uses cost their bytes, not their products (W is taken to be
//    finite: the skipped products are then zeros). Finer or coarser skips
//    measured slower on the card: one vote per 32 rows by 16 columns with
//    every mma of a group unbranched (more wasted products), and no W load
//    for slices no row of the tile uses (the branches cost more than the
//    L2 traffic they saved).
//  * bf16: mma.m16n8k16 into the fp32 sums; the products are exact.
//  * fp32: 3xTF32 on mma.m16n8k8 as in the OS kernel: hi = rna_tf32(x),
//    lo = rna_tf32(x - hi); a fragment takes a_lo.b_hi, a_hi.b_lo, a_hi.b_hi
//    per k8 step; each 16 flat columns sum into a zeroed fragment that is
//    added to the running sum by one fp32 add (round to nearest), since
//    the tensor cores' accumulate truncates. Both operands split in
//    registers (A after the mask multiply). Splitting W once per launch
//    instead, a stage holding its hi and lo, was no faster: the doubled
//    slab cost a stage or a block an SM.
//
// Add order: flat columns in order (k outer, Cin inner), 16 at a time, each
// group's sum (a fixed sequence of mma) added once; the same for every row
// of every tile, so a row's bits depend on neither M nor its tile-mates (a
// skipped fragment would have added zeros). The output is written in g's
// type.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"
#include "tma.cuh"

namespace {

using namespace spira_tc;
using namespace spira_tma;

constexpr int kThreads = 256;     // 8 warps: 4 along rows x 2 along Cout
constexpr int kBM = 128;          // rows per block
constexpr int kSliceBytes = 128;  // bytes of a row per stage
constexpr int kLdMask = kBM + 4;  // mask row per offset: conflict-free

constexpr int kStages = 3;

template <typename T> struct Mma;
template <> struct Mma<float> {
  static constexpr int kBK = 32;     // flat columns per stage
  static constexpr int kDepth = 8;   // m16n8k8 tf32
  static constexpr int kPadB = 32;
};
template <> struct Mma<__nv_bfloat16> {
  static constexpr int kBK = 64;
  static constexpr int kDepth = 16;  // m16n8k16 bf16
  static constexpr int kPadB = 16;
};

// NT: 8-column mma tiles of a warp; the block's Cout tile is BN = 16 NT.
// A stage holds A's 128 rows of the slice, W's slice rows and the slice's
// column -> offset table. kTma: A as 128-byte rows and W as boxes of 128
// bytes by kBK rows, both in the 128-byte swizzle the TMA writes (the
// 16-byte chunk c of row r at chunk c ^ (r % 8)), stages 1 KB aligned;
// else rows padded by 16 bytes (A) and 8 words or 16 bytes (W). Then the
// stages' mbarriers and the mask.
template <typename T, int NT, bool kTma> struct Tile {
  static constexpr int kSize = sizeof(T);
  static constexpr int kBN = 16 * NT;
  static constexpr int kBK = Mma<T>::kBK;
  static constexpr int kLdA = kTma ? kSliceBytes : kSliceBytes + 16;
  static constexpr int kLdB = kBN * kSize + Mma<T>::kPadB;   // cp.async
  static constexpr int kBoxN = 128 / kSize;                 // TMA box width
  static constexpr int kBoxes = (kBN + kBoxN - 1) / kBoxN;
  static constexpr int kBoxBytes = kBK * 128;
  static constexpr int kABytes = kBM * kLdA;
  static constexpr int kBBytes = kTma ? kBoxes * kBoxBytes : kBK * kLdB;
  static constexpr int kAlign = kTma ? 1024 : 16;
  static constexpr int kStageBytes =
      (kABytes + kBBytes + kBK * 4 + kAlign - 1) / kAlign * kAlign;
  static constexpr int kBarOffset = kStages * kStageBytes;
  static constexpr int kMaskOffset = kBarOffset + 8 * kStages;
  static int smem(int Kd) {
    return kMaskOffset + Kd * kLdMask + (kTma ? kAlign : 0);
  }
  // byte offset of A's row r, 16-byte chunk c
  __device__ static int a_off(int r, int c) {
    return kTma ? r * 128 + ((c ^ (r & 7)) << 4) : r * kLdA + (c << 4);
  }
  // byte offset of W's slice row k, column n (n % 8 == 0 for bf16)
  __device__ static int b_off(int k, int n) {
    if (!kTma) return k * kLdB + n * kSize;
    const int nn = n % kBoxN;
    const int c = nn * kSize >> 4;
    return (n / kBoxN) * kBoxBytes + k * 128 + ((c ^ (k & 7)) << 4) +
           (nn * kSize & 15);
  }
};

__device__ __forceinline__ bool finite_f32(uint32_t v) {
  return (v & 0x7f800000u) != 0x7f800000u;
}
__device__ __forceinline__ bool finite_bf16x2(uint32_t v) {
  return (v & 0x7f80u) != 0x7f80u && (v & 0x7f800000u) != 0x7f800000u;
}

// The TMA maps of a launch: g as [M, Kd * Cin], W as [Kd * Cin, Cout].
struct Maps {
  CUtensorMap a, b;
};

// Load flat slice c0 into a stage: A rows [row0, row0 + 128) by flat
// columns [c0, c0 + kBK), W rows [c0, c0 + kBK) by columns [n0, n0 + BN),
// and (by the first kBK threads) the slice's column -> offset table.
// TMA: thread 0 issues the boxes on the stage's mbarrier (out-of-range
// elements land as zeros); cp.async: every thread issues its copies (16,
// 8 or 4 bytes as the pitch and base allow; 2-byte loads for an odd bf16
// pitch), zero-filling past M and Kd * Cin.
template <typename T, int NT, bool kTma>
__device__ __forceinline__ void load_slice(
    char* stage, uint32_t bar, const Maps& maps, const T* g, int M,
    int Ktot, int Cin, const T* W, int Cout, int row0, int n0, int c0,
    int vecA, const Walk& wa, const Walk& wb) {
  using L = Tile<T, NT, kTma>;
  constexpr int kSize = sizeof(T);
  char* bs = stage + L::kABytes;
  if constexpr (kTma) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, L::kABytes + L::kBBytes);
      tma_load(smem_u32(stage), &maps.a, c0, row0, bar);
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b)
        tma_load(smem_u32(bs + b * L::kBoxBytes), &maps.b, n0 + b * L::kBoxN,
                 c0, bar);
    }
  } else {
    const int per_a = vecA / kSize;
    for (int r = wa.r0, q = wa.c0; r < kBM;) {
      const int c = q * per_a;
      const bool ok = row0 + r < M && c0 + c < Ktot;
      const T* src =
          ok ? g + static_cast<int64_t>(row0 + r) * Ktot + c0 + c : g;
      copy_chunk(stage + r * L::kLdA + c * kSize,
                 reinterpret_cast<const char*>(src), ok, vecA);
      r += wa.dr;
      q += wa.dc;
      if (q >= wa.chunks) {
        q -= wa.chunks;
        ++r;
      }
    }
    const int per_b = L::kBN / wb.chunks;
    for (int r = wb.r0, q = wb.c0; r < L::kBK;) {
      const int c = q * per_b;
      const bool ok = c0 + r < Ktot && n0 + c < Cout;
      const T* src =
          ok ? W + static_cast<int64_t>(c0 + r) * Cout + n0 + c : W;
      copy_chunk(bs + r * L::kLdB + c * kSize,
                 reinterpret_cast<const char*>(src), ok, per_b * kSize);
      r += wb.dr;
      q += wb.dc;
      if (q >= wb.chunks) {
        q -= wb.chunks;
        ++r;
      }
    }
  }
  int* kcol = reinterpret_cast<int*>(bs + L::kBBytes);
  if (threadIdx.x < L::kBK) {
    const int c = c0 + static_cast<int>(threadIdx.x);
    kcol[threadIdx.x] = c < Ktot ? c / Cin : 0;
  }
}

// One fp32 slice: nks k8 steps (16 flat columns per group) into acc. A
// (16 rows, k8 step) fragment whose mask is 0 everywhere and whose values
// are finite costs its ldmatrix and the vote only.
template <int NT, bool kTma>
__device__ __forceinline__ void mma_slice(const char* stage,
                                          const uint8_t* mask_s, int nks,
                                          int wr, int wc, int lane,
                                          float (&acc)[2][NT][4], float) {
  using L = Tile<float, NT, kTma>;
  const char* bs = stage + L::kABytes;
  const int* kcol = reinterpret_cast<const int*>(bs + L::kBBytes);
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int ks0 = 0; ks0 < nks; ks0 += 2) {
    uint32_t ah[2][2][4], al[2][2][4];
    bool live[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ks = ks0 + h;
        live[mt][h] = false;
        if (ks >= nks) continue;
        const int rb = wr * 32 + mt * 16;
        uint32_t raw[4];
        ldmatrix_x4(raw, smem_u32(stage + L::a_off(rb + (lane & 7) +
                                                       ((lane >> 3) & 1) * 8,
                                                   ks * 2 + (lane >> 4))));
        // a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
        const uint8_t* m0 = mask_s + kcol[ks * 8 + t] * kLdMask + rb + g;
        const uint8_t* m1 = mask_s + kcol[ks * 8 + t + 4] * kLdMask + rb + g;
        const uint32_t mk[4] = {m0[0], m0[8], m1[0], m1[8]};
        bool any = false;
#pragma unroll
        for (int i = 0; i < 4; ++i) any |= mk[i] != 0u || !finite_f32(raw[i]);
        live[mt][h] = __any_sync(0xffffffffu, any);
        if (!live[mt][h]) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i)   // times 1.0f or 0.0f
          tf32_split(__uint_as_float(raw[i]) *
                         __uint_as_float(mk[i] * 0x3f800000u),
                     ah[mt][h][i], al[mt][h][i]);
      }
    if (!(live[0][0] || live[0][1] || live[1][0] || live[1][1])) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = wc * 8 * NT + j * 8 + g;
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          tf32_split(*reinterpret_cast<const float*>(
                         bs + L::b_off((ks0 + h) * 8 + t + 4 * i, col)),
                     bh[h][i], bl[h][i]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (!(live[mt][0] || live[mt][1])) continue;
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!live[mt][h]) continue;
          // a_lo.b_hi, then a_hi.b_lo, then a_hi.b_hi
          mma_tf32(part, al[mt][h], bh[h][0], bh[h][1]);
          mma_tf32(part, ah[mt][h], bl[h][0], bl[h][1]);
          mma_tf32(part, ah[mt][h], bh[h][0], bh[h][1]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][j][i] += part[i];
      }
    }
  }
}

// One bf16 slice: nks k16 steps into acc, skips as in fp32.
template <int NT, bool kTma>
__device__ __forceinline__ void mma_slice(const char* stage,
                                          const uint8_t* mask_s, int nks,
                                          int wr, int wc, int lane,
                                          float (&acc)[2][NT][4],
                                          __nv_bfloat16) {
  using L = Tile<__nv_bfloat16, NT, kTma>;
  const char* bs = stage + L::kABytes;
  const int* kcol = reinterpret_cast<const int*>(bs + L::kBBytes);
  const int g = lane >> 2;
  const int t = lane & 3;
  const int krow = (lane & 7) + ((lane >> 3) & 1) * 8;
  for (int ks = 0; ks < nks; ++ks) {
    uint32_t a[2][4];
    bool live[2];
    // a0 (row g, cols 2t, 2t + 1), a1 (g + 8, same), a2 (g, 2t + 8, 2t + 9),
    // a3 (g + 8, same)
    const int c = ks * 16 + 2 * t;
    const int kc[4] = {kcol[c], kcol[c + 1], kcol[c + 8], kcol[c + 9]};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int rb = wr * 32 + mt * 16;
      ldmatrix_x4(a[mt], smem_u32(stage + L::a_off(rb + krow,
                                                   ks * 2 + (lane >> 4))));
      uint32_t mk[4];
      bool any = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = rb + g + (i & 1) * 8;
        const uint32_t lo = mask_s[kc[(i >> 1) * 2] * kLdMask + row];
        const uint32_t hi = mask_s[kc[(i >> 1) * 2 + 1] * kLdMask + row];
        mk[i] = lo * 0x3f80u | hi * 0x3f800000u;   // bf16 pair of 1s / 0s
        any |= mk[i] != 0u || !finite_bf16x2(a[mt][i]);
      }
      live[mt] = __any_sync(0xffffffffu, any);
      if (!live[mt]) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&a[mt][i]);
        v = __hmul2(v, *reinterpret_cast<const __nv_bfloat162*>(&mk[i]));
        a[mt][i] = *reinterpret_cast<const uint32_t*>(&v);
      }
    }
    if (!(live[0] || live[1])) continue;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, smem_u32(bs + L::b_off(ks * 16 + krow,
                                                   wc * 8 * NT + j * 8 +
                                                       (lane >> 4) * 8)));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (!live[mt]) continue;
        mma_bf16(acc[mt][j], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][j + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int NT, bool kTma>
__global__ void __launch_bounds__(kThreads, 2)
masked_group_gemm_kernel(const __grid_constant__ Maps maps,
                         const int32_t* __restrict__ m,
                         const T* __restrict__ g, int M, int Kd, int Cin,
                         const T* __restrict__ W, int Cout,
                         T* __restrict__ out, int n_col_tiles, int vecA,
                         int vecB) {
  using L = Tile<T, NT, kTma>;
  constexpr int kBK = Mma<T>::kBK;
  constexpr int kDepth = Mma<T>::kDepth;
  extern __shared__ __align__(16) char smem_raw[];
  // TMA's swizzled boxes want 1 KB aligned stages
  char* smem = smem_raw + ((L::kAlign - smem_u32(smem_raw) % L::kAlign) %
                           L::kAlign);
  const uint32_t bars = smem_u32(smem + L::kBarOffset);
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(smem + L::kMaskOffset);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 1;          // 32-row slab of the tile
  const int wc = warp & 1;           // half of the Cout tile
  const int row0 = (blockIdx.x / n_col_tiles) * kBM;
  const int n0 = (blockIdx.x % n_col_tiles) * L::kBN;
  const int Ktot = Kd * Cin;
  const int n_slices = (Ktot + kBK - 1) / kBK;
  const Walk wa = make_walk<kThreads>(kSliceBytes / vecA);
  const Walk wb =
      make_walk<kThreads>(L::kBN * static_cast<int>(sizeof(T)) / vecB);

  if (kTma && threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the map tile as a mask [Kd][128]: rows past M are masked
  {
    const int32_t* mt = m + static_cast<int64_t>(row0) * Kd;
    const int n = min(kBM, M - row0) * Kd;
    for (int e = threadIdx.x; e < kBM * Kd; e += kThreads) {
      const int r = e / Kd;
      const int k = e - r * Kd;
      mask_s[k * kLdMask + r] = e < n && mt[e] >= 0 ? 1 : 0;
    }
  }
  __syncthreads();             // barriers initialised, mask written
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.0f;

  auto load = [&](int sl) {
    const int st = sl % kStages;
    load_slice<T, NT, kTma>(smem + st * L::kStageBytes, bars + 8 * st, maps,
                            g, M, Ktot, Cin, W, Cout, row0, n0, sl * kBK,
                            vecA, wa, wb);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slices) load(s);
    if (!kTma) cp_async_commit();
  }
  for (int s = 0; s < n_slices; ++s) {
    const int st = s % kStages;
    if constexpr (kTma)
      mbar_wait(bars + 8 * st, (s / kStages) & 1);
    else
      cp_async_wait<kStages - 2>();
    __syncthreads();           // slice s landed; slice s - 1's reads are done
    if (s + kStages - 1 < n_slices) load(s + kStages - 1);
    if (!kTma) cp_async_commit();
    const int nks = (min(kBK, Ktot - s * kBK) + kDepth - 1) / kDepth;
    mma_slice<NT, kTma>(smem + st * L::kStageBytes, mask_s, nks, wr, wc,
                        lane, acc, T());
  }
  if (!kTma) cp_async_wait<0>();

  const int gq = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wr * 32 + mt * 16 + gq + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wc * 8 * NT + j * 8 + 2 * t + e;
          if (n < Cout)
            store(out + static_cast<int64_t>(r) * Cout + n,
                  acc[mt][j][2 * h + e]);
        }
    }
}

// A row-major [rows, cols] tensor as 2-D boxes of 128 bytes by box_rows
// rows, 128-byte swizzle, zeros out of range.
template <typename T>
bool make_map(CUtensorMap* map, EncodeTiled enc, const void* base,
              int64_t rows, int64_t cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / sizeof(T)),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType dt = sizeof(T) == 4
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return enc(map, dt, 2, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int NT, bool kTma>
cudaError_t launch_kernel(const Maps& maps, const void* m, const void* g,
                          int M, int Kd, int Cin, const void* W, int Cout,
                          void* out, int n_col, int vecA, int vecB,
                          cudaStream_t s) {
  using L = Tile<T, NT, kTma>;
  auto kernel = masked_group_gemm_kernel<T, NT, kTma>;
  const int bytes = L::smem(Kd);
  static int configured = 0;         // above 48 KB needs the opt-in
  if (bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = bytes;
  }
  const int64_t blocks = static_cast<int64_t>((M + kBM - 1) / kBM) * n_col;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(
      maps, static_cast<const int32_t*>(m), static_cast<const T*>(g), M, Kd,
      Cin, static_cast<const T*>(W), Cout, static_cast<T*>(out), n_col, vecA,
      vecB);
  return cudaGetLastError();
}

// TMA where g's and W's row pitches and bases are 16-byte aligned (and
// libcuda offers the encoder), else the cp.async ring.
template <typename T, int NT>
int launch_nt(const void* m, const void* g, int M, int Kd, int Cin,
              const void* W, int Cout, void* out, cudaStream_t s) {
  constexpr int kSize = sizeof(T);
  const int64_t Ktot = static_cast<int64_t>(Kd) * Cin;
  const int n_col = (Cout + 16 * NT - 1) / (16 * NT);
  Maps maps{};
  EncodeTiled enc = encode_tiled();
  const bool tma = enc && Ktot * kSize % 16 == 0 &&
                   int64_t{Cout} * kSize % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(W) % 16 == 0 &&
                   make_map<T>(&maps.a, enc, g, M, Ktot, kBM) &&
                   make_map<T>(&maps.b, enc, W, Ktot, Cout, Mma<T>::kBK);
  if (tma)
    return launch_kernel<T, NT, true>(maps, m, g, M, Kd, Cin, W, Cout, out,
                                      n_col, 16, 16, s);
  const int vecA = copy_bytes(g, Ktot * kSize, kSize);
  const int vecB = copy_bytes(W, int64_t{Cout} * kSize, kSize);
  return launch_kernel<T, NT, false>(maps, m, g, M, Kd, Cin, W, Cout, out,
                                     n_col, vecA, vecB, s);
}

template <typename T>
int launch(const void* m, const void* g, int M, int Kd, int Cin,
           const void* W, int Cout, void* out, int bn, void* stream) {
  if (M <= 0 || Cout <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 32: return launch_nt<T, 2>(m, g, M, Kd, Cin, W, Cout, out, s);
    case 64: return launch_nt<T, 4>(m, g, M, Kd, Cin, W, Cout, out, s);
    case 96: return launch_nt<T, 6>(m, g, M, Kd, Cin, W, Cout, out, s);
    case 128: return launch_nt<T, 8>(m, g, M, Kd, Cin, W, Cout, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// m: int32 [M, Kd]; g: [M, Kd, Cin]; W: [Kd, Cin, Cout]; out: [M, Cout];
// all contiguous, g / W / out of one type (fp32 or bf16); bn the Cout tile
// (32, 64, 96 or 128, from the wrapper's _tile_for).
extern "C" int spira_masked_group_gemm_f32(const void* m, const void* g,
                                           int M, int Kd, int Cin,
                                           const void* W, int Cout,
                                           void* out, int bn, void* stream) {
  return launch<float>(m, g, M, Kd, Cin, W, Cout, out, bn, stream);
}

extern "C" int spira_masked_group_gemm_bf16(const void* m, const void* g,
                                            int M, int Kd, int Cin,
                                            const void* W, int Cout,
                                            void* out, int bn, void* stream) {
  return launch<__nv_bfloat16>(m, g, M, Kd, Cin, W, Cout, out, bn, stream);
}
