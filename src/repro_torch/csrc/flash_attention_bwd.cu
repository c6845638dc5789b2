// Flash attention backward for Hopper: dQ, dK and dV of causal or full
// softmax attention, GQA by index, from the forward's row log-sum-exp.
//
// Replaces no TPU kernel: the JAX package differentiates its attention
// (src/repro/models/layers.py:26, grouped_attention) in XLA, and its Pallas
// forward (repro/kernels/flash_attention.py) has no custom VJP. The port
// runs the forward kernel of flash_attention.cu on its training path, so
// the gradient is a kernel too (the forward's wrapper would otherwise cut
// the graph). What it computes is the gradient of the forward's function:
// with s = (q . k) * scale in fp32 and the forward's lse = m + log(l),
// P = exp(s - lse) (0 where the forward masks: keys past Skv, and under
// `causal` keys with row + offset < col, offset = Skv - Sq >= 0),
// dV = P^T . dO, dP = dO . V^T, Delta = rowsum(dO o O),
// dS = P o (dP - Delta), dQ = scale * dS . K, dK = scale * dS^T . Q.
// Query head h reads KV head h / G; dK and dV of a KV head sum over its G
// query heads.
//
// FlashAttention-2's split into two kernels, neither with atomics, so two
// launches on the same inputs are bitwise equal: dQ (and Delta) first,
// then dK/dV; each sums in a fixed order.
//
// Bound on this card: operations, 2.5x the forward's (five products of the
// forward's size against its two: S recomputed, dP, dV, dQ and dK). The
// split runs seven (S and dP in each kernel), 1.4x the bound's. P is
// rounded to bf16 for dV (V's type, as the forward rounds it for P . V)
// and dS to bf16 for dQ and dK; every sum is fp32, `scale` applied at
// the end.
//
// bf16 at D = 64 and 128 (the `wg` kernels below) runs on wgmma, fed by
// TMA. The first version ran mma.sync over ldmatrix fragments with one
// cp.async stage (2.283 ms at yi-9b's shape, 2.2x SDPA's backward); what
// held it back and what this design does about it:
//
//  * Rate: every product is a wgmma m64nNk16 of a warpgroup (the card's
//    full tensor rate), bf16 into fp32. Two consumer warpgroups per block
//    own 64 rows each of its resident tile (128 query rows for dQ, 128
//    keys for dK/dV). S and dP (S^T and dP^T in dK/dV) read both operands
//    from shared memory, K-major; the products with P or dS take them
//    straight from registers (the fp32 accumulator packed to bf16 is the
//    next wgmma's A fragment, as in FlashAttention-3) against an MN-major
//    B: dQ += dS . K, dV += P^T . dO, dK += dS^T . Q. Neither P nor dS
//    goes through shared memory.
//  * Overlap: the streamed tiles (K and V for dQ; Q and dO, with their
//    lse and Delta, for dK/dV) come through a ring of stages with full and
//    empty mbarriers, loaded ahead by TMA (out-of-range rows land as
//    zeros; the masked edge test stays) while the tensor cores run.
//    Resident Q and dO (dQ) or K and V (dK/dV) are loaded once by TMA.
//    Every operand tile is 64-row boxes of 64 columns in the 128-byte
//    swizzle, read by wgmma descriptors; a TMA map per tensor over
//    (D, head, seq, batch) reads the callers' strides directly.
//  * dQ: a producer warpgroup (one thread issues the loads) gives up
//    registers by setmaxnreg (24 a thread) to the two consumers (240).
//  * dK/dV needs ~224 registers a consumer thread at D = 128 (dK and dV
//    accumulators 128, S^T and dP^T 64): ptxas held setmaxnreg regions
//    well below their count and spilled (and any extra warp rounds the
//    block's registers up to a warpgroup's), so this kernel has the two
//    consumer warpgroups only, up to 255 registers each, and its first
//    warp issues the loads: the lanes put each tile's lse and Delta into
//    its stage by 4-byte cp.async counted on the stage's barrier, lane 0
//    the TMA, and the warp refills the ring ahead without waiting where a
//    stage is still read. Its warp index comes through a shuffle,
//    warp-uniform to the compiler, which keeps the descriptors in uniform
//    registers.
//  * Order: dQ blocks take the last query rows first and dK/dV blocks the
//    first keys first: the longest walks under the causal mask start
//    first. A warpgroup skips a tile none of whose pairs is visible.
//
// bf16 at D = 256 keeps the mma.sync kernels (a dispatch by head dim: two
// warpgroups cannot hold 64 x 256 fp32 dK and dV): cp.async tiles in
// row-swizzled [64][D] shared memory; each 16-row group is split over two
// warps by output columns (each recomputes its S and dP), so no thread
// holds more than 128 accumulators. fp32 inputs run a CUDA-core variant
// of the two kernels (the forward's 16 x 16 thread grid over 64 x 64
// score tiles, fp32 tiles in shared memory, 32-row query tiles at D = 256
// to fit shared memory); they are not on the speed path.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"
#include "tma.cuh"

namespace {

constexpr int kTile = 64;         // query rows and keys per tile

struct Strides {                  // (batch, seq, head) strides in elements
  int64_t b, s, h;
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;               // [B, H, Sq]
  float* delta;                   // [B, H, Sq], written by the dQ kernel
  void* dq;                       // contiguous [B, Sq, H, D]
  void* dk;                       // contiguous [B, Skv, KV, D]
  void* dv;
  int Sq, Skv, H, KV, G;
  Strides qs, ks, vs, os, dos;
  int causal;
  float scale;
};

// a key visible to a query row (module doc)
__device__ __forceinline__ bool visible(const BwdArgs& a, int row, int col) {
  return row < a.Sq && col < a.Skv &&
         (!a.causal || row + (a.Skv - a.Sq) >= col);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

template <int D> __device__ __forceinline__ int swz(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

// cp.async rows [row0, row0 + 64) (rows `rs` elements apart) into a
// swizzled [64][D] bf16 tile; rows at or past S as zeros.
template <int D, int Threads>
__device__ __forceinline__ void load_tile(char* dst,
                                          const __nv_bfloat16* src,
                                          int64_t rs, int row0, int S) {
  constexpr int kChunks = D / 8;
  for (int e = threadIdx.x; e < kTile * kChunks; e += Threads) {
    const int r = e / kChunks;
    const int c = e % kChunks;
    const int row = row0 + r;
    const bool ok = row < S;
    spira_tc::cp_async<16>(dst + swz<D>(r, c),
                           ok ? src + row * rs + c * 8 : src, ok);
  }
}

// 16 x 64 fp32 scores of a warp's 16 rows of `a_s` against the 64 rows of
// `b_s`, both [64][D] swizzled bf16 tiles: acc[j] is the n8 tile of
// columns 8j..8j+7 in the m16n8 accumulator layout.
template <int D>
__device__ __forceinline__ void scores(float (&acc)[8][4], const char* a_s,
                                       const char* b_s, int row0, int lane) {
  using namespace spira_tc;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const int a_row = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, smem_u32(a_s + swz<D>(a_row, ks * 2 + (lane >> 4))));
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t b[4];
      const int n = j * 8 + (lane & 7) + (lane >> 4) * 8;
      ldmatrix_x4(b, smem_u32(b_s + swz<D>(n, ks * 2 + ((lane >> 3) & 1))));
      mma_bf16(acc[j], a, b[0], b[1]);
      mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// acc[j] += x . b_s over 64 k rows, for the n8 column tiles
// j0..j0 + NT - 1: x is 16 x 64 in the accumulator layout (rounded to
// bf16 here), b_s a [64][D] swizzled tile read transposed (k = its row).
template <int D, int NT>
__device__ __forceinline__ void accumulate(float (&acc)[NT][4],
                                           const float (&x)[8][4],
                                           const char* b_s, int j0,
                                           int lane) {
  using namespace spira_tc;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    const int kr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, smem_u32(b_s + swz<D>(kr, j0 + j + (lane >> 4))));
      mma_bf16(acc[j], a, b[0], b[1]);
      mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

template <int D> __host__ __device__ constexpr int split() {
  return D > 128 ? 2 : 1;
}
template <int D> __host__ __device__ constexpr int mma_threads() {
  return 128 * split<D>();
}

template <int D>
__global__ void __launch_bounds__(mma_threads<D>())
bwd_dq_mma(BwdArgs a) {
  using bf = __nv_bfloat16;
  constexpr int kThreads = mma_threads<D>();
  constexpr int kNT = D / 8 / split<D>();    // n8 output tiles per warp
  extern __shared__ __align__(128) char sm[];
  char* q_s = sm;
  char* do_s = q_s + kTile * D * 2;
  char* k_s = do_s + kTile * D * 2;          // O in the prologue, then K
  char* v_s = k_s + kTile * D * 2;
  float* delta_s = reinterpret_cast<float*>(v_s + kTile * D * 2);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp / split<D>()) * 16;   // the warp's 16 rows
  const int j0 = (warp % split<D>()) * kNT;    // its output column tiles
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int kvh = h / a.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest first
  const bf* qb = static_cast<const bf*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf* ob = static_cast<const bf*>(a.o) + b * a.os.b + h * a.os.h;
  const bf* dob = static_cast<const bf*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const bf* kb = static_cast<const bf*>(a.k) + b * a.ks.b + kvh * a.ks.h;
  const bf* vb = static_cast<const bf*>(a.v) + b * a.vs.b + kvh * a.vs.h;
  const int64_t stat = (static_cast<int64_t>(b) * a.H + h) * a.Sq;

  load_tile<D, kThreads>(q_s, qb, a.qs.s, q0, a.Sq);
  load_tile<D, kThreads>(do_s, dob, a.dos.s, q0, a.Sq);
  load_tile<D, kThreads>(k_s, ob, a.os.s, q0, a.Sq);
  spira_tc::cp_async_commit();
  spira_tc::cp_async_wait<0>();
  __syncthreads();
  // Delta = rowsum(dO o O) in fp32, d in order; one thread per row
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x;
    float acc = 0.0f;
    for (int c = 0; c < D / 8; ++c) {
      const uint4 x = *reinterpret_cast<const uint4*>(do_s + swz<D>(r, c));
      const uint4 y = *reinterpret_cast<const uint4*>(k_s + swz<D>(r, c));
      const bf* xv = reinterpret_cast<const bf*>(&x);
      const bf* yv = reinterpret_cast<const bf*>(&y);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc = fmaf(__bfloat162float(xv[e]), __bfloat162float(yv[e]), acc);
    }
    delta_s[r] = acc;
    if (q0 + r < a.Sq) a.delta[stat + q0 + r] = acc;
  }
  __syncthreads();

  const int rows[2] = {q0 + row0 + g, q0 + row0 + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse_r[i] = rows[i] < a.Sq ? a.lse[stat + rows[i]] : 0.0f;
    delta_r[i] = delta_s[row0 + g + 8 * i];
  }
  const int offset = a.Skv - a.Sq;
  int n_tiles = (a.Skv + kTile - 1) / kTile;
  if (a.causal)
    n_tiles = min(n_tiles, (min(q0 + kTile - 1, a.Sq - 1) + offset) / kTile
                               + 1);

  float dq[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.0f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                 // the last tile's reads are done
    load_tile<D, kThreads>(k_s, kb, a.ks.s, k0, a.Skv);
    load_tile<D, kThreads>(v_s, vb, a.vs.s, k0, a.Skv);
    spira_tc::cp_async_commit();
    spira_tc::cp_async_wait<0>();
    __syncthreads();

    float s[8][4], dp[8][4];
    scores<D>(s, q_s, k_s, row0, lane);
    scores<D>(dp, do_s, v_s, row0, lane);
    const bool edge = k0 + kTile > a.Skv || q0 + kTile > a.Sq ||
                      (a.causal && k0 + kTile - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int i = e >> 1;
        const float p = (!edge || visible(a, rows[i], col))
                            ? __expf(s[j][e] * a.scale - lse_r[i])
                            : 0.0f;
        s[j][e] = p * (dp[j][e] - delta_r[i]);         // dS
      }
    accumulate<D, kNT>(dq, s, k_s, j0, lane);
  }

  bf* dqb = static_cast<bf*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= a.Sq) continue;
    bf* out =
        dqb + ((static_cast<int64_t>(b) * a.Sq + rows[i]) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      *reinterpret_cast<uint32_t*>(out + (j0 + j) * 8 + 2 * t) =
          spira_tc::pack_bf16(dq[j][2 * i] * a.scale,
                              dq[j][2 * i + 1] * a.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(mma_threads<D>())
bwd_dkdv_mma(BwdArgs a) {
  using bf = __nv_bfloat16;
  constexpr int kThreads = mma_threads<D>();
  constexpr int kNT = D / 8 / split<D>();
  extern __shared__ __align__(128) char sm[];
  char* k_s = sm;
  char* v_s = k_s + kTile * D * 2;
  char* q_s = v_s + kTile * D * 2;
  char* do_s = q_s + kTile * D * 2;
  float* lse_s = reinterpret_cast<float*>(do_s + kTile * D * 2);
  float* delta_s = lse_s + kTile;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp / split<D>()) * 16;   // the warp's 16 keys
  const int j0 = (warp % split<D>()) * kNT;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / a.KV;
  const int kvh = blockIdx.x % a.KV;
  const int k0 = blockIdx.y * kTile;
  const int offset = a.Skv - a.Sq;
  const int keys[2] = {k0 + row0 + g, k0 + row0 + g + 8};

  load_tile<D, kThreads>(k_s, static_cast<const bf*>(a.k) + b * a.ks.b +
                                  kvh * a.ks.h, a.ks.s, k0, a.Skv);
  load_tile<D, kThreads>(v_s, static_cast<const bf*>(a.v) + b * a.vs.b +
                                  kvh * a.vs.h, a.vs.s, k0, a.Skv);
  spira_tc::cp_async_commit();

  float dk[kNT][4], dv[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;

  const int qt_lo = a.causal ? max(0, k0 - offset) / kTile : 0;
  const int n_qt = (a.Sq + kTile - 1) / kTile;
  for (int gi = 0; gi < a.G; ++gi) {
    const int h = kvh * a.G + gi;
    const bf* qb = static_cast<const bf*>(a.q) + b * a.qs.b + h * a.qs.h;
    const bf* dob =
        static_cast<const bf*>(a.dout) + b * a.dos.b + h * a.dos.h;
    const int64_t stat = (static_cast<int64_t>(b) * a.H + h) * a.Sq;
    for (int qt = qt_lo; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();               // the last tile's reads are done
      load_tile<D, kThreads>(q_s, qb, a.qs.s, q0, a.Sq);
      load_tile<D, kThreads>(do_s, dob, a.dos.s, q0, a.Sq);
      spira_tc::cp_async_commit();
      if (threadIdx.x < kTile) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < a.Sq ? a.lse[stat + r] : 0.0f;
        delta_s[threadIdx.x] = r < a.Sq ? a.delta[stat + r] : 0.0f;
      }
      spira_tc::cp_async_wait<0>();
      __syncthreads();

      float p[8][4];
      scores<D>(p, k_s, q_s, row0, lane);              // S^T
      const bool edge = k0 + kTile > a.Skv || q0 + kTile > a.Sq ||
                        (a.causal && k0 + kTile - 1 > q0 + offset);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);       // query in the tile
          p[j][e] = (!edge || visible(a, q0 + c, keys[e >> 1]))
                        ? __expf(p[j][e] * a.scale - lse_s[c])
                        : 0.0f;
        }
      accumulate<D, kNT>(dv, p, do_s, j0, lane);       // dV += P^T . dO
      float ds[8][4];
      scores<D>(ds, v_s, do_s, row0, lane);            // dP^T
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = p[j][e] * (ds[j][e] - delta_s[j * 8 + 2 * t + (e & 1)]);
      accumulate<D, kNT>(dk, ds, q_s, j0, lane);       // dK += dS^T . Q
    }
  }
  spira_tc::cp_async_wait<0>();      // K and V landed even with no tile

  using bf = __nv_bfloat16;
  bf* dkb = static_cast<bf*>(a.dk);
  bf* dvb = static_cast<bf*>(a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= a.Skv) continue;
    const int64_t at =
        ((static_cast<int64_t>(b) * a.Skv + keys[i]) * a.KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int c = (j0 + j) * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkb + at + c) = spira_tc::pack_bf16(
          dk[j][2 * i] * a.scale, dk[j][2 * i + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + at + c) =
          spira_tc::pack_bf16(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;  // a 16 x 16 grid: tx = tid % 16, ty
constexpr int kLdP = kTile + 16;

template <int D> __host__ __device__ constexpr int ld() { return D + 4; }

// rows [row0, row0 + n) (rows `rs` elements apart, 16-byte aligned) into
// dst[n][D + 4]; rows at or past S as zeros
template <int D>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      int64_t rs, int row0, int n, int S,
                                      float* dst) {
  constexpr int kVecs = D / 4;
  for (int e = threadIdx.x; e < n * kVecs; e += kF32Threads) {
    const int r = e / kVecs;
    const int c = (e % kVecs) * 4;
    const int row = row0 + r;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < S) x = *reinterpret_cast<const float4*>(src + row * rs + c);
    *reinterpret_cast<float4*>(dst + r * ld<D>() + c) = x;
  }
}

// s[i][j] = x[ty + 16 i] . y[tx + 16 j] over D, d in order
template <int D, int I, int J>
__device__ __forceinline__ void dots(float (&s)[I][J], const float* x_s,
                                     const float* y_s, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 xa[I], yb[J];
#pragma unroll
    for (int i = 0; i < I; ++i)
      xa[i] = *reinterpret_cast<const float4*>(x_s + (ty + 16 * i) * ld<D>()
                                               + d);
#pragma unroll
    for (int j = 0; j < J; ++j)
      yb[j] = *reinterpret_cast<const float4*>(y_s + (tx + 16 * j) * ld<D>()
                                               + d);
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        s[i][j] = fmaf(xa[i].x, yb[j].x, s[i][j]);
        s[i][j] = fmaf(xa[i].y, yb[j].y, s[i][j]);
        s[i][j] = fmaf(xa[i].z, yb[j].z, s[i][j]);
        s[i][j] = fmaf(xa[i].w, yb[j].w, s[i][j]);
      }
  }
}

// acc[i][4 jj + e] += sum over n < N of w[ty + 16 i][n] * y[n][64 jj + 4 tx
// + e], n in order (w: [64][kLdP], y: [N][D + 4])
template <int D, int N>
__device__ __forceinline__ void gemm_rows(float (&acc)[4][D / 16],
                                          const float* w_s, const float* y_s,
                                          int tx, int ty) {
#pragma unroll 2
  for (int n = 0; n < N; n += 4) {
    float4 w4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w4[i] = *reinterpret_cast<const float4*>(w_s + (ty + 16 * i) * kLdP
                                               + n);
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
#pragma unroll
      for (int jj = 0; jj < D / 64; ++jj) {
        const float4 y = *reinterpret_cast<const float4*>(
            y_s + (n + nn) * ld<D>() + jj * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = nn == 0 ? w4[i].x : nn == 1 ? w4[i].y
                        : nn == 2 ? w4[i].z : w4[i].w;
          acc[i][4 * jj + 0] = fmaf(w, y.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(w, y.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(w, y.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(w, y.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }
}

// the 16 lanes that share a row (lane bits 0-3)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D> constexpr size_t dq_f32_smem() {
  return sizeof(float) * (3 * kTile * ld<D>() + kTile * kLdP);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) bwd_dq_f32(BwdArgs a) {
  extern __shared__ float4 smf[];
  float* q_s = reinterpret_cast<float*>(smf);
  float* do_s = q_s + kTile * ld<D>();
  float* kv_s = do_s + kTile * ld<D>();        // O, then V, then K
  float* ds_s = kv_s + kTile * ld<D>();

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int kvh = h / a.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const float* kb =
      static_cast<const float*>(a.k) + b * a.ks.b + kvh * a.ks.h;
  const float* vb =
      static_cast<const float*>(a.v) + b * a.vs.b + kvh * a.vs.h;
  const int64_t stat = (static_cast<int64_t>(b) * a.H + h) * a.Sq;

  stage<D>(static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h, a.qs.s,
           q0, kTile, a.Sq, q_s);
  stage<D>(static_cast<const float*>(a.dout) + b * a.dos.b + h * a.dos.h,
           a.dos.s, q0, kTile, a.Sq, do_s);
  stage<D>(static_cast<const float*>(a.o) + b * a.os.b + h * a.os.h, a.os.s,
           q0, kTile, a.Sq, kv_s);
  __syncthreads();
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float part = 0.0f;
    for (int d = tx * 4; d < D; d += 64)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part = fmaf(do_s[r * ld<D>() + d + e], kv_s[r * ld<D>() + d + e],
                    part);
    delta_r[i] = row_sum(part);
    lse_r[i] = q0 + r < a.Sq ? a.lse[stat + q0 + r] : 0.0f;
    if (tx == 0 && q0 + r < a.Sq) a.delta[stat + q0 + r] = delta_r[i];
  }

  const int offset = a.Skv - a.Sq;
  int n_tiles = (a.Skv + kTile - 1) / kTile;
  if (a.causal)
    n_tiles = min(n_tiles, (min(q0 + kTile - 1, a.Sq - 1) + offset) / kTile
                               + 1);
  float dq[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dq[i][c] = 0.0f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                 // O / the last K reads are done
    stage<D>(vb, a.vs.s, k0, kTile, a.Skv, kv_s);
    __syncthreads();
    float dp[4][4], s[4][4];
    dots<D, 4, 4>(dp, do_s, kv_s, tx, ty);
    __syncthreads();
    stage<D>(kb, a.ks.s, k0, kTile, a.Skv, kv_s);
    __syncthreads();
    dots<D, 4, 4>(s, q_s, kv_s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ty + 16 * i;
        const int col = k0 + tx + 16 * j;
        const float p = visible(a, row, col)
                            ? expf(s[i][j] * a.scale - lse_r[i]) : 0.0f;
        ds_s[(ty + 16 * i) * kLdP + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]);
      }
    __syncthreads();
    gemm_rows<D, kTile>(dq, ds_s, kv_s, tx, ty);
  }

  float* out = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    float* o = out + ((static_cast<int64_t>(b) * a.Sq + row) * a.H + h) * D;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[jj * 64 + tx * 4 + e] = dq[i][4 * jj + e] * a.scale;
  }
}

// query rows per tile of the fp32 dK/dV kernel: 32 at D = 256, so K, V,
// Q and dO fit in shared memory
template <int D> __host__ __device__ constexpr int bq_f32() {
  return D > 128 ? 32 : 64;
}

template <int D> constexpr size_t dkdv_f32_smem() {
  return sizeof(float) * (2 * kTile * ld<D>() + 2 * bq_f32<D>() * ld<D>() +
                          kTile * kLdP + 2 * bq_f32<D>());
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) bwd_dkdv_f32(BwdArgs a) {
  constexpr int kBQ = bq_f32<D>();
  constexpr int kJ = kBQ / 16;
  extern __shared__ float4 smf[];
  float* k_s = reinterpret_cast<float*>(smf);
  float* v_s = k_s + kTile * ld<D>();
  float* q_s = v_s + kTile * ld<D>();
  float* do_s = q_s + kBQ * ld<D>();
  float* p_s = do_s + kBQ * ld<D>();           // [64 keys][kLdP]: P^T, dS^T
  float* lse_s = p_s + kTile * kLdP;
  float* delta_s = lse_s + kBQ;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int b = blockIdx.x / a.KV;
  const int kvh = blockIdx.x % a.KV;
  const int k0 = blockIdx.y * kTile;
  const int offset = a.Skv - a.Sq;
  stage<D>(static_cast<const float*>(a.k) + b * a.ks.b + kvh * a.ks.h,
           a.ks.s, k0, kTile, a.Skv, k_s);
  stage<D>(static_cast<const float*>(a.v) + b * a.vs.b + kvh * a.vs.h,
           a.vs.s, k0, kTile, a.Skv, v_s);

  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk[i][c] = dv[i][c] = 0.0f;

  const int qt_lo = a.causal ? max(0, k0 - offset) / kBQ : 0;
  const int n_qt = (a.Sq + kBQ - 1) / kBQ;
  for (int gi = 0; gi < a.G; ++gi) {
    const int h = kvh * a.G + gi;
    const int64_t stat = (static_cast<int64_t>(b) * a.H + h) * a.Sq;
    for (int qt = qt_lo; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();               // the last tile's reads are done
      stage<D>(static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h,
               a.qs.s, q0, kBQ, a.Sq, q_s);
      stage<D>(static_cast<const float*>(a.dout) + b * a.dos.b +
                   h * a.dos.h, a.dos.s, q0, kBQ, a.Sq, do_s);
      if (threadIdx.x < kBQ) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < a.Sq ? a.lse[stat + r] : 0.0f;
        delta_s[threadIdx.x] = r < a.Sq ? a.delta[stat + r] : 0.0f;
      }
      __syncthreads();
      float p[4][kJ], dp[4][kJ];
      dots<D, 4, kJ>(p, k_s, q_s, tx, ty);             // S^T
      dots<D, 4, kJ>(dp, v_s, do_s, tx, ty);           // dP^T
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int c = tx + 16 * j;
          p[i][j] = visible(a, q0 + c, k0 + ty + 16 * i)
                        ? expf(p[i][j] * a.scale - lse_s[c]) : 0.0f;
          p_s[(ty + 16 * i) * kLdP + c] = p[i][j];
        }
      __syncthreads();
      gemm_rows<D, kBQ>(dv, p_s, do_s, tx, ty);        // dV += P^T . dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int c = tx + 16 * j;
          p_s[(ty + 16 * i) * kLdP + c] = p[i][j] * (dp[i][j] - delta_s[c]);
        }
      __syncthreads();
      gemm_rows<D, kBQ>(dk, p_s, q_s, tx, ty);         // dK += dS^T . Q
    }
  }

  float* dkb = static_cast<float*>(a.dk);
  float* dvb = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.Skv) continue;
    const int64_t at = ((static_cast<int64_t>(b) * a.Skv + key) * a.KV + kvh)
                       * D;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dkb[at + jj * 64 + tx * 4 + e] = dk[i][4 * jj + e] * a.scale;
        dvb[at + jj * 64 + tx * 4 + e] = dv[i][4 * jj + e];
      }
  }
}

// ---------------------------------------------------------------------------
// bf16 at D = 64 and 128 on Hopper: wgmma, TMA, warp specialisation
// ---------------------------------------------------------------------------

namespace wg {

using namespace spira_tma;

constexpr int kThreads = 384;      // dQ: two consumer warpgroups, a producer
constexpr int kRows = 64;          // rows of a consumer warpgroup, of a box
constexpr int kBox = kRows * 128;  // one 64 x 64 bf16 box, 128-byte swizzle
constexpr int kStages = 2;         // dQ's ring of streamed tiles
constexpr int kDkvThreads = 256;   // dK/dV: two consumer warpgroups only
constexpr int kDkvStages = 3;      // dK/dV's ring
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kWaitCycles = 1ll << 34;   // ~9 s at 1.98 GHz

// 2^x by the SFU (ex2.approx, relative error ~2^-22): no branch, unlike
// exp2f's range handling
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// every wait of these kernels: a stalled ring traps instead of hanging
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  mbar_wait_or_trap(bar, parity, kWaitCycles);
}

// TMA maps over (D, head, seq, batch) of q, k, v and dout
struct Maps {
  CUtensorMap q, k, v, dout;
};

// Shared memory of the dQ kernel: the block's Q and dO ([warpgroup][D/64]
// boxes each), the ring's stages (K's D/64 boxes, then V's), the block's
// Delta, then the mbarriers (full and empty per stage, the resident load).
template <int D> struct DqLayout {
  static constexpr int kNb = D / 64;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + 2 * kNb * kBox;
  static constexpr int kStage0 = kDo + 2 * kNb * kBox;
  static constexpr int kStageBytes = 2 * kNb * kBox;
  static constexpr int kDelta = kStage0 + kStages * kStageBytes;
  static constexpr int kBars = kDelta + 2 * kRows * 4;
  static constexpr int kAlloc = kBars + 8 * (2 * kStages + 1) + 1024;
};

// Shared memory of the dK/dV kernel: the block's K and V, the ring's
// stages (Q's boxes, dO's, then the tile's 64 log2-scaled lse and 64
// Delta), then the mbarriers.
template <int D> struct DkvLayout {
  static constexpr int kNb = D / 64;
  static constexpr int kK = 0;
  static constexpr int kV = kK + 2 * kNb * kBox;
  static constexpr int kStage0 = kV + 2 * kNb * kBox;
  static constexpr int kStats = 2 * kNb * kBox;   // within a stage
  static constexpr int kStageBytes =
      (kStats + 2 * kRows * 4 + 1023) / 1024 * 1024;
  static constexpr int kBars = kStage0 + kDkvStages * kStageBytes;
  static constexpr int kAlloc = kBars + 8 * (2 * kDkvStages + 1) + 1024;
};

// k16 step kk of a K-major operand: a [D/64][rows][64] tile read along D
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int kk) {
  return spira_tc::wgmma_desc(tile + (kk >> 2) * kBox + (kk & 3) * 32, 16,
                              1024);
}
// k16 step kk of an MN-major operand: rows 16kk.. of a [D/64][64][64]
// tile, all D columns (one box to the next is 64 columns)
__device__ __forceinline__ uint64_t mndesc(uint32_t tile, int kk) {
  return spira_tc::wgmma_desc(tile + kk * 2048, kBox, 1024);
}

// d += A . B, A a register fragment, B an MN-major [k][D] tile
template <int D>
__device__ __forceinline__ void rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                   uint64_t db) {
  if constexpr (D == 64)
    spira_tc::wgmma_rs_n64(d, a, db, 1);
  else
    spira_tc::wgmma_rs_n128(d, a, db, 1);
}

// d = A . B^T over D (S or dP of a 64 x 64 tile), both K-major tiles
template <int D>
__device__ __forceinline__ void ss(float (&d)[32], uint32_t at, uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    spira_tc::wgmma_ss_n64(d, kdesc(at, kk), kdesc(bt, kk), kk > 0);
}

// a barrier of one consumer warpgroup (named barrier 1 or 2)
__device__ __forceinline__ void group_sync(int grp) {
  if (grp == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t align_1k(const char* p) {
  const uint32_t a = spira_tc::smem_u32(p);
  return (a + 1023u) & ~1023u;
}

// dQ (and Delta): one block per 128 query rows of one (batch, head), the
// last rows first (they walk the most key tiles under the causal mask).
// Warpgroup 2 produces: its first thread loads the block's Q and dO once,
// then K and V tiles of 64 keys into the ring. Warpgroups 0 and 1 each own
// 64 rows: Delta of their rows, then per key tile S = Q . K^T and
// dP = dO . V^T (wgmma, both operands in shared memory), P and dS in
// registers, dQ += dS . K (dS from registers, K MN-major).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_wgmma(const __grid_constant__ Maps maps, const BwdArgs a) {
  using L = DqLayout<D>;
  using bf = __nv_bfloat16;
  extern __shared__ __align__(16) char smraw[];
  const uint32_t base = align_1k(smraw);
  char* sm = smraw + (base - spira_tc::smem_u32(smraw));
  const uint32_t full = base + L::kBars;
  const uint32_t empty = full + 8 * kStages;
  const uint32_t res = empty + 8 * kStages;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 2 * kRows;
  const int offset = a.Skv - a.Sq;
  int n_tiles = (a.Skv + kRows - 1) / kRows;
  if (a.causal)
    n_tiles = min(n_tiles,
                  (min(q0 + 2 * kRows - 1, a.Sq - 1) + offset) / kRows + 1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_init(res, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's index, warp-uniform for the compiler (setmaxnreg)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 2) {
    // ---- producer warpgroup: one thread issues, 24 registers each ----
    spira_tc::regs_dealloc<24>();
    if (threadIdx.x == 256) {
      const int kvh = h / a.G;
      mbar_expect_tx(res, 4 * L::kNb * kBox);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < L::kNb; ++c) {
          const int at = (w * L::kNb + c) * kBox;
          tma_load_4d(base + L::kQ + at, &maps.q, 64 * c, h,
                      q0 + kRows * w, b, res);
          tma_load_4d(base + L::kDo + at, &maps.dout, 64 * c, h,
                      q0 + kRows * w, b, res);
        }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % kStages;
        const int u = kt / kStages;
        if (u > 0) bar_wait(empty + 8 * st, (u - 1) & 1);
        const uint32_t sb = base + L::kStage0 + st * L::kStageBytes;
        mbar_expect_tx(full + 8 * st, L::kStageBytes);
        for (int c = 0; c < L::kNb; ++c) {
          tma_load_4d(sb + c * kBox, &maps.k, 64 * c, kvh, kt * kRows, b,
                      full + 8 * st);
          tma_load_4d(sb + (L::kNb + c) * kBox, &maps.v, 64 * c, kvh,
                      kt * kRows, b, full + 8 * st);
        }
      }
    }
  } else {
    // ---- consumers ----
    spira_tc::regs_alloc<240>();
    const int grp = role;
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32;
    const int lane = tw % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int r0 = q0 + kRows * grp;
    const int64_t stat = (static_cast<int64_t>(b) * a.H + h) * a.Sq;
    float* delta_s = reinterpret_cast<float*>(sm + L::kDelta) + kRows * grp;
    {  // Delta = rowsum(dO o O) of the group's rows, two threads a row
      const int rr = tw / 2;
      const int half = tw % 2;
      const int row = r0 + rr;
      float acc = 0.0f;
      if (row < a.Sq) {
        const bf* x = static_cast<const bf*>(a.dout) + b * a.dos.b +
                      row * a.dos.s + h * a.dos.h + half * (D / 2);
        const bf* y = static_cast<const bf*>(a.o) + b * a.os.b +
                      row * a.os.s + h * a.os.h + half * (D / 2);
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const uint4 xv = *reinterpret_cast<const uint4*>(x + 8 * c);
          const uint4 yv = *reinterpret_cast<const uint4*>(y + 8 * c);
          const bf* xe = reinterpret_cast<const bf*>(&xv);
          const bf* ye = reinterpret_cast<const bf*>(&yv);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc = fmaf(__bfloat162float(xe[e]), __bfloat162float(ye[e]), acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) {
        delta_s[rr] = acc;
        if (row < a.Sq) a.delta[stat + row] = acc;
      }
    }
    group_sync(grp);

    const int rows[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lse_r[i] = rows[i] < a.Sq ? a.lse[stat + rows[i]] * kLog2e : 0.0f;
      delta_r[i] = delta_s[16 * warp + g + 8 * i];
    }
    const float sl2 = a.scale * kLog2e;
    int last = -1;                   // the group's last key tile with work
    if (r0 < a.Sq)
      last = a.causal ? min(n_tiles - 1,
                            (min(r0 + kRows - 1, a.Sq - 1) + offset) / kRows)
                      : n_tiles - 1;
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
    const uint32_t qa = base + L::kQ + grp * L::kNb * kBox;
    const uint32_t doa = base + L::kDo + grp * L::kNb * kBox;
    bar_wait(res, 0);

    for (int kt = 0; kt < n_tiles; ++kt) {
      const int st = kt % kStages;
      bar_wait(full + 8 * st, (kt / kStages) & 1);
      if (kt <= last) {
        const uint32_t kb = base + L::kStage0 + st * L::kStageBytes;
        const uint32_t vb = kb + L::kNb * kBox;
        float s[32], dp[32];
        spira_tc::wgmma_fence();
        ss<D>(s, qa, kb);
        spira_tc::wgmma_commit();
        ss<D>(dp, doa, vb);
        spira_tc::wgmma_commit();
        spira_tc::wgmma_wait<1>();
        spira_tc::fence_regs(s);
        const int k0 = kt * kRows;
        const bool edge = k0 + kRows > a.Skv || r0 + kRows > a.Sq ||
                          (a.causal && k0 + kRows - 1 > r0 + offset);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int col = k0 + 8 * j + 2 * t + (e & 1);
            const float p = fast_exp2(fmaf(s[4 * j + e], sl2, -lse_r[i]));
            s[4 * j + e] = (!edge || visible(a, rows[i], col)) ? p : 0.0f;
          }
        spira_tc::wgmma_wait<0>();
        spira_tc::fence_regs(dp);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * j + e] *= dp[4 * j + e] - delta_r[e >> 1];      // dS
        uint32_t ds[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) spira_tc::acc_to_a(ds[kk], s, kk);
        spira_tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) rs<D>(dq, ds[kk], mndesc(kb, kk));
        spira_tc::wgmma_commit();
        spira_tc::wgmma_wait<0>();
        spira_tc::fence_regs(dq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) spira_tc::fence_regs(ds[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }

    bf* dqb = static_cast<bf*>(a.dq);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] >= a.Sq) continue;
      bf* out =
          dqb + ((static_cast<int64_t>(b) * a.Sq + rows[i]) * a.H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * t) =
            spira_tc::pack_bf16(dq[4 * j + 2 * i] * a.scale,
                                dq[4 * j + 2 * i + 1] * a.scale);
    }
  }
}

// dK and dV: one block per 128 keys of one (batch, KV head), the first keys
// first (under the causal mask they see the most query tiles). Warpgroups
// 0 and 1 each own 64 keys: S^T = K . Q^T and dP^T = V . dO^T (both
// operands in shared memory), P^T and dS^T in registers, dV += P^T . dO
// and dK += dS^T . Q (A from registers, B MN-major), for each of the KV
// head's G query heads in order and each query tile of 64 rows that sees
// the block's keys. The first warp also loads (module note): the block's
// K and V once, then the tiles' Q, dO, lse and Delta into the ring. The
// GQA sum happens inside the block, in a fixed order.
template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
bwd_dkdv_wgmma(const __grid_constant__ Maps maps, const BwdArgs a) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(16) char smraw[];
  const uint32_t base = align_1k(smraw);
  char* sm = smraw + (base - spira_tc::smem_u32(smraw));
  const uint32_t full = base + L::kBars;
  const uint32_t empty = full + 8 * kDkvStages;
  const uint32_t res = empty + 8 * kDkvStages;
  const int b = blockIdx.x / a.KV;
  const int kvh = blockIdx.x % a.KV;
  const int k0 = blockIdx.y * 2 * kRows;
  const int offset = a.Skv - a.Sq;
  const int qt_lo = a.causal ? max(0, k0 - offset) / kRows : 0;
  const int n_q = max(0, (a.Sq + kRows - 1) / kRows - qt_lo);
  const int n_it = a.G * n_q;        // tile it: head gi = it / n_q, in order
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(full + 8 * s, 33);   // 32 lanes' copies and the TMA's
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_init(res, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int grp = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tw = threadIdx.x % 128;
  const int warp = tw / 32;
  const int lane = tw % 32;
  // warp 0 also loads; the warp's index from a shuffle is warp-uniform
  // for the compiler, so the loop's descriptors stay in uniform registers
  const bool loader = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0) == 0;
  // warp 0: tile j into its stage (free), all asynchronous, so the warp
  // never waits on device memory: the tile's lse and Delta by 4-byte
  // cp.async from the lanes (zeros past Sq), each lane's copies counted
  // on the stage's barrier when they land; Q and dO by TMA from lane 0
  auto load = [&](int j) {
    const int st = j % kDkvStages;
    const int h = kvh * a.G + j / n_q;
    const int q0 = (qt_lo + j % n_q) * kRows;
    const int64_t stat = (static_cast<int64_t>(b) * a.H + h) * a.Sq;
    const int sbo = L::kStage0 + st * L::kStageBytes;
    float* ls = reinterpret_cast<float*>(sm + sbo + L::kStats);
    for (int r = lane; r < kRows; r += 32) {
      const bool ok = q0 + r < a.Sq;
      spira_tc::cp_async<4>(ls + r, a.lse + (ok ? stat + q0 + r : 0), ok);
      spira_tc::cp_async<4>(ls + kRows + r,
                            a.delta + (ok ? stat + q0 + r : 0), ok);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 ::"r"(full + 8 * st)
                 : "memory");
    if (lane == 0) {
      const uint32_t sb = base + sbo;
      mbar_expect_tx(full + 8 * st, L::kStats);
      for (int c = 0; c < L::kNb; ++c) {
        tma_load_4d(sb + c * kBox, &maps.q, 64 * c, h, q0, b, full + 8 * st);
        tma_load_4d(sb + (L::kNb + c) * kBox, &maps.dout, 64 * c, h, q0, b,
                    full + 8 * st);
      }
    }
  };
  int issued = 0;                    // tiles loaded so far (warp 0)
  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(res, 4 * L::kNb * kBox);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < L::kNb; ++c) {
          const int at = (w * L::kNb + c) * kBox;
          tma_load_4d(base + L::kK + at, &maps.k, 64 * c, kvh,
                      k0 + kRows * w, b, res);
          tma_load_4d(base + L::kV + at, &maps.v, 64 * c, kvh,
                      k0 + kRows * w, b, res);
        }
    }
    for (; issued < min(kDkvStages, n_it); ++issued) load(issued);
  }

  const int g = lane / 4;
  const int t = lane % 4;
  const int kw = k0 + kRows * grp;
  const int keys[2] = {kw + 16 * warp + g, kw + 16 * warp + g + 8};
  const float sl2 = a.scale * kLog2e;
  const uint32_t ka = base + L::kK + grp * L::kNb * kBox;
  const uint32_t va = base + L::kV + grp * L::kNb * kBox;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;
  bar_wait(res, 0);

  for (int it = 0; it < n_it; ++it) {
    if (loader) {
      // refill the ring up to kDkvStages - 1 tiles ahead: a stage whose
      // last tile the other warpgroup still reads is left for the next
      // iteration, unless this tile needs it now
      while (issued < n_it && issued < it + kDkvStages) {
        const int st = issued % kDkvStages;
        const uint32_t parity = (issued / kDkvStages - 1) & 1;
        if (issued == it)
          bar_wait(empty + 8 * st, parity);
        else if (!__shfl_sync(
                     0xffffffffu,
                     static_cast<int>(lane == 0 && mbar_test(empty + 8 * st,
                                                             parity)),
                     0))
          break;
        load(issued++);
      }
    }
    {
      const int st = it % kDkvStages;
      bar_wait(full + 8 * st, (it / kDkvStages) & 1);
      const int q0 = (qt_lo + it % n_q) * kRows;
      if (kw < a.Skv &&
          !(a.causal && min(q0 + kRows - 1, a.Sq - 1) + offset < kw)) {
        const int sbo = L::kStage0 + st * L::kStageBytes;
        const uint32_t qb = base + sbo;
        const uint32_t dob = qb + L::kNb * kBox;
        const float* ls = reinterpret_cast<const float*>(sm + sbo +
                                                         L::kStats);
        float s[32], dp[32];
        spira_tc::wgmma_fence();
        ss<D>(s, ka, qb);                                   // S^T
        spira_tc::wgmma_commit();
        ss<D>(dp, va, dob);                                 // dP^T
        spira_tc::wgmma_commit();
        spira_tc::wgmma_wait<1>();
        spira_tc::fence_regs(s);
        const bool edge = kw + kRows > a.Skv || q0 + kRows > a.Sq ||
                          (a.causal && kw + kRows - 1 > q0 + offset);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
          const float m0 = -l2.x * kLog2e;
          const float m1 = -l2.y * kLog2e;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * t + (e & 1);      // query in the tile
            const float p =
                fast_exp2(fmaf(s[4 * j + e], sl2, (e & 1) ? m1 : m0));
            s[4 * j + e] =
                (!edge || visible(a, q0 + c, keys[e >> 1])) ? p : 0.0f;
          }
        }
        spira_tc::wgmma_wait<0>();                         // dP^T landed
        spira_tc::fence_regs(dp);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(ls + kRows + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)                       // dS^T
            dp[4 * j + e] = s[4 * j + e] *
                            (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        }
        // P^T and dS^T as bf16 A fragments: the fp32 tiles die here, so
        // the two products below run with 64 fewer live registers
        uint32_t pa[4][4], ds[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          spira_tc::acc_to_a(pa[kk], s, kk);
          spira_tc::acc_to_a(ds[kk], dp, kk);
        }
        spira_tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) rs<D>(dv, pa[kk], mndesc(dob, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) rs<D>(dk, ds[kk], mndesc(qb, kk));
        spira_tc::wgmma_commit();
        spira_tc::wgmma_wait<0>();
        spira_tc::fence_regs(dk);
        spira_tc::fence_regs(dv);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          spira_tc::fence_regs(pa[kk]);
          spira_tc::fence_regs(ds[kk]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
  }

  using bf = __nv_bfloat16;
  bf* dkb = static_cast<bf*>(a.dk);
  bf* dvb = static_cast<bf*>(a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= a.Skv) continue;
    const int64_t at =
        ((static_cast<int64_t>(b) * a.Skv + keys[i]) * a.KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(dkb + at + c) = spira_tc::pack_bf16(
          dk[4 * j + 2 * i] * a.scale, dk[4 * j + 2 * i + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + at + c) = spira_tc::pack_bf16(
          dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
    }
  }
}

// A bf16 [B, seq, heads, D] tensor as a TMA map over (D, head, seq,
// batch), boxes of 64 columns by 64 rows of one (batch, head), 128-byte
// swizzle, zeros past every edge. A dimension of extent 1 is given a
// packed stride (its own is never read).
bool make_map(CUtensorMap* map, EncodeTiled enc, const void* base, int D,
              int heads, int seq, int batch, const Strides& st) {
  const int64_t sh = heads > 1 ? st.h : D;
  const int64_t ss = seq > 1 ? st.s : sh * heads;
  const int64_t sb = batch > 1 ? st.b : ss * seq;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const BwdArgs& a, int B, cudaStream_t s) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  Maps maps;
  if (!make_map(&maps.q, enc, a.q, D, a.H, a.Sq, B, a.qs) ||
      !make_map(&maps.k, enc, a.k, D, a.KV, a.Skv, B, a.ks) ||
      !make_map(&maps.v, enc, a.v, D, a.KV, a.Skv, B, a.vs) ||
      !make_map(&maps.dout, enc, a.dout, D, a.H, a.Sq, B, a.dos))
    return cudaErrorInvalidValue;
  static bool configured = false;    // above 48 KB needs the opt-in
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DqLayout<D>::kAlloc);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bwd_dkdv_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DkvLayout<D>::kAlloc);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  bwd_dq_wgmma<D><<<dim3(B * a.H, (a.Sq + 2 * kRows - 1) / (2 * kRows)),
                    kThreads, DqLayout<D>::kAlloc, s>>>(maps, a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkdv_wgmma<D><<<dim3(B * a.KV, (a.Skv + 2 * kRows - 1) / (2 * kRows)),
                      kDkvThreads, DkvLayout<D>::kAlloc, s>>>(maps, a);
  return cudaGetLastError();
}

// The helpers' own check: x = a . b^T (wgmma from shared memory, both
// K-major, as S and dP) and y = bf16(x) . v (A from registers, v MN-major,
// as dQ, dK and dV), a, b, v bf16 [64, D] by the backward's TMA maps; one
// warpgroup.
template <int D>
__global__ void __launch_bounds__(128)
wgmma_check_kernel(const __grid_constant__ Maps maps, float* x, float* y) {
  constexpr int kNb = D / 64;
  extern __shared__ __align__(16) char smraw[];
  const uint32_t base = align_1k(smraw);
  const uint32_t bar = base + 3 * kNb * kBox;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 3 * kNb * kBox);
    for (int c = 0; c < kNb; ++c) {
      tma_load_4d(base + c * kBox, &maps.q, 64 * c, 0, 0, 0, bar);
      tma_load_4d(base + (kNb + c) * kBox, &maps.k, 64 * c, 0, 0, 0, bar);
      tma_load_4d(base + (2 * kNb + c) * kBox, &maps.v, 64 * c, 0, 0, 0,
                  bar);
    }
  }
  bar_wait(bar, 0);
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  float s[32];
  spira_tc::wgmma_fence();
  ss<D>(s, base, base + kNb * kBox);
  spira_tc::wgmma_commit();
  spira_tc::wgmma_wait<0>();
  spira_tc::fence_regs(s);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[(16 * warp + g + 8 * (e >> 1)) * 64 + 8 * j + 2 * t + (e & 1)] =
          s[4 * j + e];
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) spira_tc::acc_to_a(pa[kk], s, kk);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  spira_tc::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    rs<D>(o, pa[kk], mndesc(base + 2 * kNb * kBox, kk));
  spira_tc::wgmma_commit();
  spira_tc::wgmma_wait<0>();
  spira_tc::fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) spira_tc::fence_regs(pa[kk]);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[(16 * warp + g + 8 * (e >> 1)) * D + 8 * j + 2 * t + (e & 1)] =
          o[4 * j + e];
}

template <int D>
int check(const void* a, const void* b, const void* v, float* x, float* y,
          cudaStream_t s) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const Strides st{64 * D, D, D};
  Maps maps{};
  if (!make_map(&maps.q, enc, a, D, 1, 64, 1, st) ||
      !make_map(&maps.k, enc, b, D, 1, 64, 1, st) ||
      !make_map(&maps.v, enc, v, D, 1, 64, 1, st))
    return cudaErrorInvalidValue;
  const int bytes = 3 * (D / 64) * kBox + 8 + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_check_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  wgmma_check_kernel<D><<<1, 128, bytes, s>>>(maps, x, y);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int configure(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
int launch_d(const BwdArgs& a, int B, cudaStream_t s) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  void (*dq)(BwdArgs);
  void (*dkdv)(BwdArgs);
  size_t dq_bytes, dkdv_bytes;
  int threads;
  if constexpr (kMma) {
    dq = bwd_dq_mma<D>;
    dkdv = bwd_dkdv_mma<D>;
    dq_bytes = 4 * kTile * D * 2 + kTile * sizeof(float);
    dkdv_bytes = 4 * kTile * D * 2 + 2 * kTile * sizeof(float);
    threads = mma_threads<D>();
  } else {
    dq = bwd_dq_f32<D>;
    dkdv = bwd_dkdv_f32<D>;
    dq_bytes = dq_f32_smem<D>();
    dkdv_bytes = dkdv_f32_smem<D>();
    threads = kF32Threads;
  }
  static bool configured = false;    // above 48 KB needs the opt-in
  if (!configured) {
    int e = configure(dq, dq_bytes);
    if (e == cudaSuccess) e = configure(dkdv, dkdv_bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dq<<<dim3(B * a.H, (a.Sq + kTile - 1) / kTile), threads, dq_bytes, s>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkdv<<<dim3(B * a.KV, (a.Skv + kTile - 1) / kTile), threads, dkdv_bytes,
         s>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, int D,
           const int64_t* st, int causal, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return cudaSuccess;
  if (Skv <= 0 || KV <= 0 || H % KV != 0 || (causal && Sq > Skv))
    return cudaErrorInvalidValue;
  BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse),
            static_cast<float*>(delta), dq, dk, dv, Sq, Skv, H, KV, H / KV,
            {st[0], st[1], st[2]}, {st[3], st[4], st[5]},
            {st[6], st[7], st[8]}, {st[9], st[10], st[11]},
            {st[12], st[13], st[14]}, causal, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    switch (D) {       // a kernel by head dim: wgmma at 64 and 128
      case 64: return wg::launch<64>(a, B, s);
      case 128: return wg::launch<128>(a, B, s);
      case 256: return launch_d<T, 256>(a, B, s);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (D) {
      case 64: return launch_d<T, 64>(a, B, s);
      case 128: return launch_d<T, 128>(a, B, s);
      case 256: return launch_d<T, 256>(a, B, s);
      default: return cudaErrorInvalidValue;
    }
  }
}

}  // namespace

// q, o, dout: [B, Sq, H, D]; k, v: [B, Skv, KV, D], each read through its
// (batch, seq, head) strides in elements (strides[0..2] q's, [3..5] k's,
// [6..8] v's, [9..11] o's, [12..14] dout's; D contiguous, every row
// 16-byte aligned); lse: the forward's contiguous fp32 [B, H, Sq]; delta:
// fp32 [B, H, Sq] scratch; dq: contiguous [B, Sq, H, D]; dk, dv:
// contiguous [B, Skv, KV, D]. One type for q, k, v, o, dout and the
// gradients (fp32 or bf16); D in {64, 128, 256}; H a multiple of KV;
// `causal` needs Sq <= Skv. Two launches on the stream: dQ (and delta),
// then dK/dV.
extern "C" int spira_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int H, int KV, int D,
    const int64_t* strides, int causal, float scale, void* stream) {
  return launch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv,
                       H, KV, D, strides, causal, scale, stream);
}

extern "C" int spira_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int H, int KV, int D,
    const int64_t* strides, int causal, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                               Sq, Skv, H, KV, D, strides, causal, scale,
                               stream);
}

// The wgmma helpers' check (chip_smoke.py): a, b, v contiguous bf16
// [64, D], D in {64, 128}; x = a . b^T fp32 [64, 64]; y = bf16(x) . v fp32
// [64, D].
extern "C" int spira_wgmma_check(const void* a, const void* b, const void* v,
                                 void* x, void* y, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xf = static_cast<float*>(x);
  float* yf = static_cast<float*>(y);
  switch (D) {
    case 64: return wg::check<64>(a, b, v, xf, yf, s);
    case 128: return wg::check<128>(a, b, v, xf, yf, s);
    default: return cudaErrorInvalidValue;
  }
}
