// Flash attention (forward) for Hopper: causal or full softmax attention
// with an online softmax over KV tiles, GQA by index.
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
// head, about half of it under `causal`), bytes for short prompts. This
// first version runs on the CUDA cores in fp32: 256 threads, each owning a
// 4 x 4 tile of the 64 x 64 scores and 4 rows x D/16 columns of the
// output; Q, the K tile (then the V tile, in the same buffer) and P are
// staged in shared memory as fp32 with 16-byte loads and stores, rows
// padded so that the 16-byte reads of a quarter warp hit distinct banks.
// wgmma, TMA and a pipeline of tiles are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;
constexpr int kLdP = kBK + 16;   // P row stride: the two half-warps of a
                                 // store land 16 banks apart
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
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
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<int64_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        o[jj * 64 + tx * 4 + t] = from_float<T>(acc[i][4 * jj + t] / denom);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Skv, int H, int KV, const int64_t* st, int causal,
             float scale, cudaStream_t s) {
  auto kernel = flash_attention_kernel<T, D>;
  constexpr size_t bytes = smem_bytes<D>();
  static bool configured = false;    // above 48 KB needs the opt-in
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, H / KV,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int KV, int D, const int64_t* strides,
           int causal, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return cudaSuccess;
  if (Skv <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_d<T, 64>(q, k, v, out, B, Sq, Skv, H, KV, strides, causal,
                             scale, s);
    case 128:
      return launch_d<T, 128>(q, k, v, out, B, Sq, Skv, H, KV, strides,
                              causal, scale, s);
    case 256:
      return launch_d<T, 256>(q, k, v, out, B, Sq, Skv, H, KV, strides,
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
// H a multiple of KV.
extern "C" int spira_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int Sq, int Skv, int H, int KV,
                                         int D, const int64_t* strides,
                                         int causal, float scale,
                                         void* stream) {
  return launch<float>(q, k, v, out, B, Sq, Skv, H, KV, D, strides, causal,
                       scale, stream);
}

extern "C" int spira_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int Sq, int Skv, int H, int KV,
                                          int D, const int64_t* strides,
                                          int causal, float scale,
                                          void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KV, D, strides,
                               causal, scale, stream);
}
