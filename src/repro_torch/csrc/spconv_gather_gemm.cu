// Output-stationary implicit-GEMM sparse convolution for Hopper:
//   out[i] = sum_k 1[m[i,k] >= 0] * F[m[i,k]] @ W[k]
//
// Replaces the TPU kernel repro/kernels/spconv_gather_gemm.py::
// spconv_gather_gemm (_kernel). As there, the kernel-map gather happens
// inside the kernel: no [M, Kd, Cin] gathered tensor ever exists in device
// memory.
//
// Grid (ceil(M/64), ceil(Cout/64)); one block owns a 64x64 output tile and
// loops over the offsets k. Per k it loads the tile's 64 map entries, and
// per 16-channel slice of Cin it gathers the 64 input rows (coalesced along
// Cin, zero where m < 0 or past Cin) and stages W[k]'s slice, both in
// shared memory as fp32; each of the 256 threads keeps a 4x4 fp32 register
// tile. An offset that no row of the tile uses is skipped: it could only
// add +0 terms, which never change an fp32 sum that starts at +0.
//
// Bound on this card: operations for the wide layers (2 * nnz * Cin * Cout
// fp32 FMAs on CUDA cores; the reference contract is IEEE fp32, so the
// tensor cores' TF32 is not used), bytes for the stem (Cin = 4). This first
// version stages through shared memory without cp.async, TMA or wgmma; its
// FMA loop is shared-memory bound, and the PAD-row tiles of the coarse
// levels cost only their map reads.
//
// Add order: for every output element, k outer and Cin inner, one fmaf per
// term into one accumulator. It does not depend on M or on where the row
// sits in its tile, which keeps a batch of B bitwise equal to B single
// runs. bf16 inputs convert with __bfloat162float and accumulate in fp32;
// the output is written in the input's type.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;   // 16 x 16, each a 4 x 4 register tile
constexpr int kTM = 4;
constexpr int kTN = 4;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_gemm_kernel(const T* __restrict__ F, int Cin,
                   const int32_t* __restrict__ m, int M, int Kd,
                   const T* __restrict__ W, int Cout, T* __restrict__ out) {
  __shared__ int idx_s[kBM];
  __shared__ float a_s[kBK][kBM + 1];   // gathered rows, channel-major
  __shared__ float b_s[kBK][kBN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k = 0; k < Kd; ++k) {
    int mine = -1;
    if (threadIdx.x < kBM) {
      const int r = row0 + threadIdx.x;
      mine = r < M ? m[static_cast<size_t>(r) * Kd + k] : -1;
      idx_s[threadIdx.x] = mine;
    }
    if (!__syncthreads_or(mine >= 0)) continue;   // offset unused by the tile
    const T* wk = W + static_cast<size_t>(k) * Cin * Cout;
    for (int c0 = 0; c0 < Cin; c0 += kBK) {
      for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
        const int r = e / kBK;
        const int c = e % kBK;
        const int j = idx_s[r];
        float v = 0.0f;
        if (j >= 0 && c0 + c < Cin)
          v = to_float(F[static_cast<size_t>(j) * Cin + c0 + c]);
        a_s[c][r] = v;
      }
      for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
        const int c = e / kBN;
        const int n = e % kBN;
        float v = 0.0f;
        if (c0 + c < Cin && col0 + n < Cout)
          v = to_float(wk[static_cast<size_t>(c0 + c) * Cout + col0 + n]);
        b_s[c][n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kBK; ++c) {
        float a[kTM], b[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = a_s[c][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = b_s[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = col0 + tx + 16 * j;
      if (n < Cout)
        out[static_cast<size_t>(r) * Cout + n] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* F, int Cin, const void* m, int M, int Kd,
           const void* W, int Cout, void* out, void* stream) {
  if (M <= 0 || Cout <= 0) return cudaSuccess;
  const dim3 grid((M + kBM - 1) / kBM, (Cout + kBN - 1) / kBN);
  gather_gemm_kernel<T><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(F), Cin, static_cast<const int32_t*>(m), M, Kd,
      static_cast<const T*>(W), Cout, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// F: [N, Cin]; m: int32 [M, Kd]; W: [Kd, Cin, Cout]; out: [M, Cout]; all
// contiguous, F / W / out of one type (fp32 or bf16).
extern "C" int spira_spconv_gather_gemm_f32(
    const void* F, int Cin, const void* m, int M, int Kd, const void* W,
    int Cout, void* out, void* stream) {
  return launch<float>(F, Cin, m, M, Kd, W, Cout, out, stream);
}

extern "C" int spira_spconv_gather_gemm_bf16(
    const void* F, int Cin, const void* m, int M, int Kd, const void* W,
    int Cout, void* out, void* stream) {
  return launch<__nv_bfloat16>(F, Cin, m, M, Kd, W, Cout, out, stream);
}
