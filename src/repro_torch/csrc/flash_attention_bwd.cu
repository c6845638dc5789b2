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
// launches on the same inputs are bitwise equal:
//
//  * dQ (one block per 64 query rows of one (batch, head)): a prologue
//    computes Delta of its rows (fp32, d in order) and writes it out for
//    the second kernel; then the key tiles up to the diagonal in order:
//    recompute S and P, dP, dS, and dQ += dS . K in fp32 registers.
//  * dK/dV (one block per 64 keys of one (batch, KV head)): K and V stay in
//    shared memory; the block walks the KV head's G query heads, and for
//    each the query tiles that see its keys, in that fixed order:
//    recompute S^T = K . Q^T and P^T, dV += P^T . dO, dP^T = V . dO^T,
//    dS^T, dK += dS^T . Q. The GQA sum happens inside the block.
//
// Bound on this card: operations, 2.5x the forward's (five products of the
// forward's size against its two: S recomputed, dP, dV, dQ and dK). The
// split runs seven (S and dP in each kernel), 1.4x the bound's. bf16 inputs run mma.sync m16n8k16 (fp32 accumulators) with
// bf16 tiles brought in by cp.async into row-swizzled [64][D] tiles, as
// the forward; P is rounded to bf16 for dV (V's type, as the forward
// rounds it for P . V) and dS to bf16 for dQ and dK. At D = 256 each
// 16-row group is split over two warps by output columns (each recomputes
// its S and dP), so no thread holds more than 128 accumulators. fp32
// inputs run a CUDA-core variant of the same two kernels (the forward's
// 16 x 16 thread grid over 64 x 64 score tiles, fp32 tiles in shared
// memory, 32-row query tiles at D = 256 to fit shared memory).
//
// Simple first: one stage of tiles, no double buffering, no wgmma, TMA or
// warp specialisation (later work).
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

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
  switch (D) {
    case 64: return launch_d<T, 64>(a, B, s);
    case 128: return launch_d<T, 128>(a, B, s);
    case 256: return launch_d<T, 256>(a, B, s);
    default: return cudaErrorInvalidValue;
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
