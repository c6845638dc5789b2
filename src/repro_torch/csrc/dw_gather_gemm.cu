// Weight gradient of a sparse convolution, per offset, gather fused in:
//   dW[k] = sum_r G_k[r]^T g[r],   G_k[r] = F[m[r,k]] (0 where m[r,k] < 0)
//
// A port-only kernel: the JAX reference computes this contraction
// (repro/core/dataflow.py::_dw_per_offset) in XLA, outside any Pallas
// kernel. The contraction runs over the capacity-sized row axis, and the
// reference fixes its grouping (chunked_rowdot): rows are cut into panels
// of Q rows from row 0, a panel adds its rows in row order, and the panel
// partials combine in panel order. That grouping is what keeps weight
// gradients bitwise equal when the buffer is zero-extended to a larger
// capacity bucket (appended rows only add exact zeros). It also rules out
// atomics and any split of the row axis other than the panels.
//
// Two passes, as the segment sum:
//   pass 1 (dw_panel_kernel): one block per (offset k, panel p, 64-wide
//   Cin tile, 64-wide Cout tile), 256 threads with a 4 x 4 fp32 register
//   tile each. Per 16-row step it loads the step's map entries, gathers
//   F[m[r,k]] itself (zero where m < 0) and stages g's rows, both as fp32
//   in shared memory, then every thread adds the 16 rows in row order by
//   fmaf into its accumulators, which start at +0.0. A step whose 16 map
//   entries are all invalid is skipped: it could only add exact zeros
//   (fmaf(+-0, g, acc) == acc for an accumulator that starts at +0.0).
//   Every block writes its partial, zeros included.
//   pass 2 (dw_combine_kernel): one thread per (k, i, j) adds the P panel
//   partials in panel order from +0.0.
// The head's weight gradient uses the same kernel with the identity map
// (m[r, 0] = r, Kd = 1).
//
// Bound on this card: operations for the wide layers (2 * nnz * Cin * Cout
// fp32 FMAs on CUDA cores, the reference contract is IEEE fp32, so no
// TF32); the partials ([Kd * P, Cin, Cout] fp32, written and read once)
// are bytes. This first version stages through shared memory without
// cp.async, TMA or wgmma.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBI = 64;         // Cin tile
constexpr int kBJ = 64;         // Cout tile
constexpr int kBR = 16;         // rows staged per step
constexpr int kThreads = 256;   // 16 x 16 threads, each 4 x 4 outputs
constexpr int kTI = 4;
constexpr int kTJ = 4;
constexpr int kCombineThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_panel_kernel(const T* __restrict__ F, int Cin,
                const int32_t* __restrict__ m, int M, int Kd,
                const T* __restrict__ g, int Cout, int Q, int P,
                float* __restrict__ partial) {
  __shared__ int idx_s[kBR];
  __shared__ float a_s[kBR][kBI];   // gathered features, row-major
  __shared__ float b_s[kBR][kBJ];   // output gradient rows
  const int k = blockIdx.x / P;
  const int p = blockIdx.x % P;
  const int i0 = blockIdx.y * kBI;
  const int j0 = blockIdx.z * kBJ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[kTI][kTJ];
#pragma unroll
  for (int a = 0; a < kTI; ++a)
#pragma unroll
    for (int b = 0; b < kTJ; ++b) acc[a][b] = 0.0f;

  const int r_begin = p * Q;
  const int r_end = min(M, r_begin + Q);
  for (int r0 = r_begin; r0 < r_end; r0 += kBR) {
    int mine = -1;
    if (threadIdx.x < kBR) {
      const int r = r0 + threadIdx.x;
      mine = r < r_end ? m[static_cast<size_t>(r) * Kd + k] : -1;
      idx_s[threadIdx.x] = mine;
    }
    if (!__syncthreads_or(mine >= 0)) continue;   // only zeros to add
    for (int e = threadIdx.x; e < kBR * kBI; e += kThreads) {
      const int rr = e / kBI;
      const int i = e % kBI;
      const int j = idx_s[rr];
      float v = 0.0f;
      if (j >= 0 && i0 + i < Cin)
        v = to_float(F[static_cast<size_t>(j) * Cin + i0 + i]);
      a_s[rr][i] = v;
    }
    for (int e = threadIdx.x; e < kBR * kBJ; e += kThreads) {
      const int rr = e / kBJ;
      const int jj = e % kBJ;
      const int r = r0 + rr;
      float v = 0.0f;
      if (r < r_end && j0 + jj < Cout)
        v = to_float(g[static_cast<size_t>(r) * Cout + j0 + jj]);
      b_s[rr][jj] = v;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kBR; ++rr) {
      float a[kTI], b[kTJ];
#pragma unroll
      for (int x = 0; x < kTI; ++x) a[x] = a_s[rr][ty + 16 * x];
#pragma unroll
      for (int y = 0; y < kTJ; ++y) b[y] = b_s[rr][tx + 16 * y];
#pragma unroll
      for (int x = 0; x < kTI; ++x)
#pragma unroll
        for (int y = 0; y < kTJ; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
    }
    __syncthreads();
  }
  float* dst = partial + static_cast<size_t>(blockIdx.x) * Cin * Cout;
#pragma unroll
  for (int x = 0; x < kTI; ++x) {
    const int i = i0 + ty + 16 * x;
    if (i >= Cin) continue;
#pragma unroll
    for (int y = 0; y < kTJ; ++y) {
      const int j = j0 + tx + 16 * y;
      if (j < Cout) dst[static_cast<size_t>(i) * Cout + j] = acc[x][y];
    }
  }
}

__global__ void __launch_bounds__(kCombineThreads)
dw_combine_kernel(const float* __restrict__ partial, int Kd, int P,
                  int per_k, float* __restrict__ out) {
  const size_t e = static_cast<size_t>(blockIdx.x) * kCombineThreads +
                   threadIdx.x;
  if (e >= static_cast<size_t>(Kd) * per_k) return;
  const size_t k = e / per_k;
  const size_t ij = e - k * per_k;
  const float* src = partial + k * P * per_k + ij;
  float acc = 0.0f;
  for (int p = 0; p < P; ++p) acc = acc + src[static_cast<size_t>(p) * per_k];
  out[e] = acc;
}

template <typename T>
int launch(const void* F, int Cin, const void* m, int M, int Kd,
           const void* g, int Cout, int Q, void* partial, void* out,
           void* stream) {
  if (Kd <= 0 || Cin <= 0 || Cout <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = M > 0 ? (M + Q - 1) / Q : 0;
  const int per_k = Cin * Cout;
  if (P > 0) {
    const dim3 grid(Kd * P, (Cin + kBI - 1) / kBI, (Cout + kBJ - 1) / kBJ);
    dw_panel_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(F), Cin, static_cast<const int32_t*>(m), M, Kd,
        static_cast<const T*>(g), Cout, Q, P, static_cast<float*>(partial));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const size_t elems = static_cast<size_t>(Kd) * per_k;
  const unsigned blocks =
      static_cast<unsigned>((elems + kCombineThreads - 1) / kCombineThreads);
  dw_combine_kernel<<<blocks, kCombineThreads, 0, s>>>(
      static_cast<const float*>(partial), Kd, P, per_k,
      static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// F: [N, Cin]; m: int32 [M, Kd]; g: [M, Cout] (F and g of one type, fp32
// or bf16); Q: panel rows, a multiple of 16; partial: fp32 scratch
// [Kd * ceil(M / Q), Cin, Cout]; out: fp32 [Kd, Cin, Cout]. All contiguous.
extern "C" int spira_dw_gather_gemm_f32(
    const void* F, int Cin, const void* m, int M, int Kd, const void* g,
    int Cout, int Q, void* partial, void* out, void* stream) {
  return launch<float>(F, Cin, m, M, Kd, g, Cout, Q, partial, out, stream);
}

extern "C" int spira_dw_gather_gemm_bf16(
    const void* F, int Cin, const void* m, int M, int Kd, const void* g,
    int Cout, int Q, void* partial, void* out, void* stream) {
  return launch<__nv_bfloat16>(F, Cin, m, M, Kd, g, Cout, Q, partial, out,
                               stream);
}
