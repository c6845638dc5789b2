// Masked grouped GEMM over a pre-gathered tensor, for Hopper:
//   out[i] = sum_k 1[m[i,k] >= 0] * g[i,k] @ W[k]
//
// Replaces the TPU kernel repro/kernels/masked_group_gemm.py::
// masked_group_gemm (_kernel): the unfused output-stationary baseline,
// whose caller has already gathered g[i, k, :] = F[max(m[i,k], 0)] into an
// [M, Kd, Cin] tensor in device memory. The TPU kernel walks Kd on a
// sequential grid axis with the output tile resident in VMEM; here one
// block owns a 64-row x 64-column output tile and loops over k itself.
//
// Per k the block loads the tile's 64 map entries as a 0/1 mask in shared
// memory; per 16-channel slice of Cin it stages the 64 rows of g[:, k, :]
// (contiguous in memory, so with 16-byte loads when Cin allows) and W[k]'s
// slice, both as fp32. The mask is applied in registers by a multiply, as
// the TPU kernel does: an offset is never skipped, so a non-finite value
// the caller left in g at a masked position reaches the output exactly as
// it does there. Each of the 256 threads keeps a 4 x 4 fp32 register tile
// and adds its terms by fmaf in one fixed order, k outer and Cin inner, so
// a row's result does not depend on M. Ragged edges of M, Cin and Cout are
// masked here (the TPU version asserted divisibility). bf16 inputs convert
// with __bfloat162float; the output is written in g's type.
//
// Bound on this card: operations at the MinkUNet widths (2 * M * Kd * Cin *
// Cout fp32 FMAs, all of them computed; the useful share is the valid
// entries'), bytes for the stem (Cin = 4: the gathered tensor dominates).
// This first version stages through shared memory without cp.async, TMA or
// wgmma.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;
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

// Stage rows [row0, row0 + 64) of g[:, k, c0:c0+16] into a_s[c][r] as
// fp32, times the row's mask. kVec: the 16-channel slice of every row is
// 16-byte aligned and whole (Cin % 16 == 0), so it moves in uint4 loads.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_g(const T* __restrict__ g, int M,
                                        int Kd, int Cin, int k, int row0,
                                        int c0, const float* mask_s,
                                        float (*a_s)[kBM + 1]) {
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(T);          // elements per uint4
    constexpr int kVecs = kBK / kPer;             // uint4 per row slice
    for (int e = threadIdx.x; e < kBM * kVecs; e += kThreads) {
      const int r = e / kVecs;
      const int v = e % kVecs;
      const int row = row0 + r;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (row < M)
        raw = *reinterpret_cast<const uint4*>(
            g + (static_cast<size_t>(row) * Kd + k) * Cin + c0 + v * kPer);
      const T* vals = reinterpret_cast<const T*>(&raw);
      const float mk = mask_s[r];
#pragma unroll
      for (int t = 0; t < kPer; ++t)
        a_s[v * kPer + t][r] = to_float(vals[t]) * mk;
    }
  } else {
    for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK;
      const int c = e % kBK;
      const int row = row0 + r;
      float v = 0.0f;
      if (row < M && c0 + c < Cin)
        v = to_float(g[(static_cast<size_t>(row) * Kd + k) * Cin + c0 + c]) *
            mask_s[r];
      a_s[c][r] = v;
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
masked_group_gemm_kernel(const int32_t* __restrict__ m,
                         const T* __restrict__ g, int M, int Kd, int Cin,
                         const T* __restrict__ W, int Cout,
                         T* __restrict__ out) {
  __shared__ float mask_s[kBM];
  __shared__ float a_s[kBK][kBM + 1];   // masked rows, channel-major
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
    if (threadIdx.x < kBM) {
      const int r = row0 + threadIdx.x;
      mask_s[threadIdx.x] =
          (r < M && m[static_cast<size_t>(r) * Kd + k] >= 0) ? 1.0f : 0.0f;
    }
    __syncthreads();
    const T* wk = W + static_cast<size_t>(k) * Cin * Cout;
    for (int c0 = 0; c0 < Cin; c0 += kBK) {
      stage_g<T, kVec>(g, M, Kd, Cin, k, row0, c0, mask_s, a_s);
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
int launch(const void* m, const void* g, int M, int Kd, int Cin,
           const void* W, int Cout, void* out, void* stream) {
  if (M <= 0 || Cout <= 0) return cudaSuccess;
  const dim3 grid((M + kBM - 1) / kBM, (Cout + kBN - 1) / kBN);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* mp = static_cast<const int32_t*>(m);
  const auto* gp = static_cast<const T*>(g);
  const auto* wp = static_cast<const T*>(W);
  auto* op = static_cast<T*>(out);
  // 16-byte loads need every row slice aligned: Cin a multiple of 16 and
  // g itself 16-byte aligned (the wrapper passes a fresh contiguous copy
  // otherwise)
  const bool vec = Cin % kBK == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  if (vec)
    masked_group_gemm_kernel<T, true><<<grid, kThreads, 0, s>>>(
        mp, gp, M, Kd, Cin, wp, Cout, op);
  else
    masked_group_gemm_kernel<T, false><<<grid, kThreads, 0, s>>>(
        mp, gp, M, Kd, Cin, wp, Cout, op);
  return cudaGetLastError();
}

}  // namespace

// m: int32 [M, Kd]; g: [M, Kd, Cin]; W: [Kd, Cin, Cout]; out: [M, Cout];
// all contiguous, g / W / out of one type (fp32 or bf16).
extern "C" int spira_masked_group_gemm_f32(const void* m, const void* g,
                                           int M, int Kd, int Cin,
                                           const void* W, int Cout,
                                           void* out, void* stream) {
  return launch<float>(m, g, M, Kd, Cin, W, Cout, out, stream);
}

extern "C" int spira_masked_group_gemm_bf16(const void* m, const void* g,
                                            int M, int Kd, int Cin,
                                            const void* W, int Cout,
                                            void* out, void* stream) {
  return launch<__nv_bfloat16>(m, g, M, Kd, Cin, W, Cout, out, stream);
}
