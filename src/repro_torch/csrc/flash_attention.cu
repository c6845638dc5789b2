// Flash attention (forward) for Hopper: causal or full softmax attention
// with an online softmax over KV tiles, GQA by index. Given a buffer, it
// also writes each row's log-sum-exp (m + log l, fp32), which the backward
// kernels of flash_attention_bwd.cu recompute the probabilities from.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_kernel). There the grid's innermost axis walks the KV blocks in order
// and carries the running (m, l, acc) in VMEM scratch; here one block owns
// 64 query rows of one (batch, head) and loops over 64-key tiles itself,
// with (m, l, acc) in registers. What it computes is the TPU kernel's
// function: s = (q . k) * scale in fp32, keys with row + offset < col
// masked to the finite -1e30 under `causal` (offset = Skv - Sq puts the
// diagonal at the end of the keys), m_new = max(m, rowmax s),
// p = exp(s - m_new), l = exp(m - m_new) * l + rowsum p, p rounded to V's
// type before acc = exp(m - m_new) * acc + p . V, and out = acc /
// max(l, 1e-30) in q's type. Tiles that every row of the block masks are
// skipped, as the TPU kernel's pl.when(run) does, except in a block that
// holds a row with no visible key at all (Sq > Skv under `causal`): there
// every tile runs, so such a row averages V over all keys as the reference
// (flash_attention_ref) does, and the other rows gain exact zeros. Query
// head h reads KV head h / G (the reference's jnp.repeat, never
// materialised). q, k and v are read through their strides ([B, S, heads,
// D] with D contiguous), so the caller needs no transpose; the output is
// contiguous [B, Sq, H, D]. Ragged Sq and Skv are masked here (the TPU
// version asserted divisibility); keys past Skv get p = 0.
//
// Bound on this card: operations for prefill lengths (4 * Sq * Skv * D per
// head, about half of it under `causal`), bytes for short prompts. Two
// kernels compute that function:
//
//  * bf16 (flash_mma_kernel, the LM's path): FlashAttention-2 style on the
//    tensor cores. The first version staged bf16 tiles as fp32 and ran
//    fp32 FMAs on the CUDA cores (29 TFLOP/s at a 2,000-token prefill); the
//    tensor cores' bf16 rate is ~15x the CUDA cores' fp32 rate, so this
//    one keeps the data in bf16 and multiplies with mma.sync. 4 warps own
//    16 query rows each; their Q fragments stay in registers (D <= 128;
//    at D = 256 the 128 fp32 accumulators a lane holds leave no room, and
//    Q is read from shared memory by ldmatrix at every tile). K and V
//    tiles of 64 keys are brought in as bf16 by 16-byte cp.async into
//    [64][D] tiles whose 16-byte chunks are swizzled by the row, so the 8
//    rows an ldmatrix reads hit 8 bank groups; V of tile t loads while
//    Q . K of t runs, K of tile t + 1 while P . V of t runs. S = Q . K^T by
//    mma.m16n8k16 (K by ldmatrix), the mask and the online softmax in
//    registers with quad shuffles for the row max and sum (exp by
//    __expf, one ex2.approx: within 2 + 1.2|x| fp32 ulps, far below the
//    bf16 rounding of p, and ~10x fewer instructions than expf, which
//    would otherwise take longer than the tile's mma), and P rounded to bf16 in
//    registers is the A operand of P . V (V by ldmatrix.trans). l sums the
//    unrounded fp32 p. Each score sums its D
//    products inside the mma instructions, k16 step by k16 step; each
//    output element adds the tiles in key order into one accumulator.
//  * fp32 (flash_attention_kernel, the JAX sweep's shapes and the fp32 LM
//    tests): the first version, on the CUDA cores: 256 threads, each
//    owning a 4 x 4 tile of the 64 x 64 scores and 4 rows x D/16 columns
//    of the output; Q, the K tile (then the V tile, in the same buffer)
//    and P are staged in shared memory as fp32 with 16-byte loads and
//    stores, rows padded so that the 16-byte reads of a quarter warp hit
//    distinct banks.
//
// wgmma, TMA and warp specialisation are later work.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;
constexpr int kLdP = kBK + 16;   // P row stride: the two half-warps of a
                                 // store land 16 banks apart
constexpr float kNegInf = -1e30f;

// the CUDA-core kernel runs only fp32 (bf16 has the tensor-core kernel)
__device__ __forceinline__ float to_float(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
// p as the reference's p.astype(v.dtype) leaves it, back in fp32
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

template <int D> __host__ __device__ constexpr int row_stride() {
  return D + 4;
}

template <int D> constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBQ * row_stride<D>() + kBQ * kLdP);
}

// Stage rows [row0, row0 + 64) of one head (rows `rs` elements apart, D
// contiguous, 16-byte aligned) into dst[64][D + 4] as fp32; rows at or
// past S as zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ src, int64_t rs,
                                      int row0, int S, float* dst) {
  constexpr int kPer = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int kVecs = D / kPer;          // loads per row
  for (int e = threadIdx.x; e < kBK * kVecs; e += kThreads) {
    const int r = e / kVecs;
    const int c = (e % kVecs) * kPer;
    const int row = row0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row < S)
      raw = *reinterpret_cast<const uint4*>(src + row * rs + c);
    const T* vals = reinterpret_cast<const T*>(&raw);
    float4* d = reinterpret_cast<float4*>(dst + r * row_stride<D>() + c);
#pragma unroll
    for (int t = 0; t < kPer / 4; ++t)
      d[t] = make_float4(to_float(vals[4 * t]), to_float(vals[4 * t + 1]),
                         to_float(vals[4 * t + 2]), to_float(vals[4 * t + 3]));
  }
}

// reductions over the 16 lanes that share a row group (lane bits 0-3)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int Sq,
                       int Skv, int H, int G, int64_t qsb, int64_t qss,
                       int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                       int64_t vsb, int64_t vss, int64_t vsh, int causal,
                       float scale) {
  constexpr int kLd = row_stride<D>();
  constexpr int kCols = D / 64;            // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [64][kLd]
  float* kv_s = q_s + kBQ * kLd;                  // [64][kLd]: K, then V
  float* p_s = kv_s + kBK * kLd;                  // [64][kLdP]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / G;
  // the longest causal rows first: they have the most tiles
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int offset = Skv - Sq;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  stage<T, D>(q + b * qsb + h * qsh, qss, q0, Sq, q_s);

  int n_tiles = (Skv + kBK - 1) / kBK;
  if (causal && q0 + offset >= 0) {
    const int q_hi = min(q0 + kBQ - 1, Sq - 1);
    n_tiles = min(n_tiles, (q_hi + offset) / kBK + 1);
  }

  float m[4], l[4], acc[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                 // the last tile's P . V reads are done
    stage<T, D>(kb, kss, k0, Skv, kv_s);
    __syncthreads();

    // s = q . k over D, in order
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bk[j] = *reinterpret_cast<const float4*>(kv_s + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
        }
    }

    // mask, online softmax, P in V's type
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= Skv || (causal && row + offset < col)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = col < Skv ? expf(s[i][j] - m_new) : 0.0f;
        ps += p;
        p_s[(ty + 16 * i) * kLdP + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = alpha * l[i] + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                 // K reads done, P written
    stage<T, D>(vb, vss, k0, Skv, kv_s);
    __syncthreads();

    // acc += P . V, keys in order
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * kLdP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(
              kv_s + (c + cc) * kLd + jj * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? p4[i].x : cc == 1 ? p4[i].y
                          : cc == 2 ? p4[i].z : p4[i].w;
            acc[i][4 * jj + 0] = fmaf(p, vv.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(p, vv.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(p, vv.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(p, vv.w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    if (lse != nullptr && tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + row] = m[i] + logf(l[i]);
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<int64_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        o[jj * 64 + tx * 4 + t] = from_float<T>(acc[i][4 * jj + t] / denom);
  }
}

// ---------------------------------------------------------------------------
// bf16: FlashAttention-2 style on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps, 16 query rows each

// Byte offset of 16-byte chunk c of row r in a [64][D] bf16 tile whose
// chunks are swizzled by the row (c ^ (r & 7)): the 8 rows an ldmatrix
// reads at one logical chunk land in 8 different bank groups.
template <int D> __device__ __forceinline__ int swz(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

template <int D> constexpr size_t mma_smem_bytes() {
  return 3 * kBQ * D * 2;          // Q, K and V tiles as bf16
}

// cp.async rows [row0, row0 + 64) of one head (rows `rs` elements apart,
// D contiguous, 16-byte aligned) into a swizzled [64][D] bf16 tile; rows
// at or past S as zeros.
template <int D>
__device__ __forceinline__ void load_tile(char* dst,
                                          const __nv_bfloat16* src,
                                          int64_t rs, int row0, int S) {
  constexpr int kChunks = D / 8;
  for (int e = threadIdx.x; e < kBK * kChunks; e += kMmaThreads) {
    const int r = e / kChunks;
    const int c = e % kChunks;
    const int row = row0 + r;
    const bool ok = row < S;
    spira_tc::cp_async<16>(dst + swz<D>(r, c),
                           ok ? src + row * rs + c * 8 : src, ok);
  }
}

// reductions over the 4 lanes that hold one row of a fragment (lane bits
// 0-1)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int Sq, int Skv, int H,
                 int G, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                 int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                 int64_t vsh, int causal, float scale) {
  using namespace spira_tc;
  constexpr bool kQInRegs = D <= 128;   // D = 256 keeps Q in shared memory
  constexpr int kDSteps = D / 16;       // k16 steps of Q . K over D
  constexpr int kOTiles = D / 8;        // n8 tiles of the output
  extern __shared__ __align__(128) char fsm[];
  char* q_s = fsm;
  char* k_s = q_s + kBQ * D * 2;
  char* v_s = k_s + kBK * D * 2;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / G;
  // the longest causal rows first: they have the most tiles
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int offset = Skv - Sq;
  const __nv_bfloat16* kb = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kvh * vsh;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile<D>(q_s, q + b * qsb + h * qsh, qss, q0, Sq);
  load_tile<D>(k_s, kb, kss, 0, Skv);
  cp_async_commit();

  int n_tiles = (Skv + kBK - 1) / kBK;
  if (causal && q0 + offset >= 0) {
    const int q_hi = min(q0 + kBQ - 1, Sq - 1);
    n_tiles = min(n_tiles, (q_hi + offset) / kBK + 1);
  }

  uint32_t qf[kQInRegs ? kDSteps : 1][4];
  float o[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    cp_async_wait<0>();
    __syncthreads();           // K (and Q) landed; V's last readers are done
    load_tile<D>(v_s, vb, vss, k0, Skv);
    cp_async_commit();
    if (kQInRegs && kt == 0) {
#pragma unroll
      for (int ks = 0; ks < kDSteps; ++ks)
        ldmatrix_x4(qf[kQInRegs ? ks : 0],
                    smem_u32(q_s + swz<D>(a_row, ks * 2 + (lane >> 4))));
    }

    // s = q . k over D
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
      } else {
        ldmatrix_x4(a, smem_u32(q_s + swz<D>(a_row, ks * 2 + (lane >> 4))));
      }
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bk[4];
        const int key = j * 8 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(bk, smem_u32(k_s + swz<D>(key, ks * 2 +
                                                       ((lane >> 3) & 1))));
        mma_bf16(s[j], a, bk[0], bk[1]);
        mma_bf16(s[j + 1], a, bk[2], bk[3]);
      }
    }

    // mask, online softmax in registers, P as bf16 A fragments
    const bool edge = k0 + kBK > Skv || (causal && k0 + kBK - 1 > q0 + offset);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        if (edge && (col >= Skv || (causal && rows[e >> 1] + offset < col)))
          x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_new[2], alpha[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m_run[i], quad_max(mx[i]));
      alpha[i] = __expf(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const float p =
            col < Skv ? __expf(s[j][e] - m_new[e >> 1]) : 0.0f;
        ps[e >> 1] += p;
        s[j][e] = p;
      }
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l_run[i] = alpha[i] * l_run[i] + quad_sum(ps[i]);
#pragma unroll
    for (int j = 0; j < kOTiles; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    cp_async_wait<0>();
    __syncthreads();           // V landed; every warp's K reads are done
    if (kt + 1 < n_tiles) load_tile<D>(k_s, kb, kss, k0 + kBK, Skv);
    cp_async_commit();         // K of tile t + 1 loads during P . V of t

    // acc += P . V, keys in order
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < kOTiles; j += 2) {
        uint32_t bv[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(bv, smem_u32(v_s + swz<D>(key, j + (lane >> 4))));
        mma_bf16(o[j], pf[kk], bv[0], bv[1]);
        mma_bf16(o[j + 1], pf[kk], bv[2], bv[3]);
      }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= Sq) continue;
    if (lse != nullptr && t == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + rows[i]] =
          m_run[i] + logf(l_run[i]);
    const float denom = fmaxf(l_run[i], 1e-30f);
    __nv_bfloat16* op =
        out + ((static_cast<int64_t>(b) * Sq + rows[i]) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kOTiles; ++j)
      *reinterpret_cast<uint32_t*>(op + j * 8 + 2 * t) = pack_bf16(
          o[j][2 * i] / denom, o[j][2 * i + 1] / denom);
  }
}

// fp32 runs the CUDA-core kernel above, bf16 the tensor-core one
template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int Sq, int Skv, int H, int KV,
             const int64_t* st, int causal, float scale, cudaStream_t s) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  void (*kernel)(const T*, const T*, const T*, T*, float*, int, int, int,
                 int, int64_t, int64_t, int64_t, int64_t, int64_t, int64_t,
                 int64_t, int64_t, int64_t, int, float);
  if constexpr (kMma)
    kernel = flash_mma_kernel<D>;
  else
    kernel = flash_attention_kernel<T, D>;
  constexpr size_t bytes = kMma ? mma_smem_bytes<D>() : smem_bytes<D>();
  constexpr int threads = kMma ? kMmaThreads : kThreads;
  static bool configured = false;    // above 48 KB needs the opt-in
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, threads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Skv, H,
      H / KV,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int B, int Sq, int Skv, int H, int KV, int D,
           const int64_t* strides, int causal, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return cudaSuccess;
  if (Skv <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 64:
      return launch_d<T, 64>(q, k, v, out, l, B, Sq, Skv, H, KV, strides,
                             causal, scale, s);
    case 128:
      return launch_d<T, 128>(q, k, v, out, l, B, Sq, Skv, H, KV, strides,
                              causal, scale, s);
    case 256:
      return launch_d<T, 256>(q, k, v, out, l, B, Sq, Skv, H, KV, strides,
                              causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, Sq, H, D]; k, v: [B, Skv, KV, D], each read through its (batch,
// seq, head) strides in elements (strides[0..2] q's, [3..5] k's, [6..8]
// v's; D contiguous, every row 16-byte aligned); out: contiguous
// [B, Sq, H, D]. One type for all four (fp32 or bf16); D in {64, 128, 256};
// H a multiple of KV. lse: null, or a contiguous fp32 [B, H, Sq] that gets
// each row's log-sum-exp m + log(l) (the backward's input; a null pointer
// writes nothing else and changes no other value).
extern "C" int spira_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         int B, int Sq, int Skv, int H,
                                         int KV, int D,
                                         const int64_t* strides, int causal,
                                         float scale, void* stream) {
  return launch<float>(q, k, v, out, lse, B, Sq, Skv, H, KV, D, strides,
                       causal, scale, stream);
}

extern "C" int spira_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* out, void* lse,
                                          int B, int Sq, int Skv, int H,
                                          int KV, int D,
                                          const int64_t* strides, int causal,
                                          float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Skv, H, KV, D,
                               strides, causal, scale, stream);
}
