// Weight-stationary sparse convolution for Hopper: a GEMM over the kept
// (input, offset) pairs, then an ordered merge into the output rows:
//   out[i] = sum over k in column order, where pair (i, k) was kept,
//            of F[m[i,k]] @ W[k]
//
// Replaces the TPU kernel repro/kernels/ws_scatter_gemm.py::ws_scatter_gemm
// (_kernel). That kernel keeps the whole [M, bn] output block in VMEM and
// sweeps (offset, chunk) on the TPU's sequential grid, which is what orders
// its merge. Hopper has neither a sequential grid nor megabytes of fast
// memory, so the sweep is split at the only point where order matters:
//
//   compaction (in torch, int32, before the launch): per offset k the first
//   `capacity` valid rows survive; their input rows are laid out as one flat
//   pair table pin[p] ordered by (offset, position in the column), with
//   cnt[k] pairs of offset k starting at choff[k], and pidx[i, k] the pair
//   index of (row i, offset k) or -1 where the pair is absent or dropped.
//   The tables are sized by the kept pairs, never by Ks * capacity.
//
//   pass A (ws_gemm_kernel): a grouped gather-GEMM over the pair table. The
//   grid is a flat list of 64-pair chunks (chunk_off[k] = first chunk of
//   offset k) times Cout tiles of 16 * TN channels, so no block idles on a
//   short column. A block gathers its chunk's 64 input rows and W[k]'s slice
//   into shared memory as fp32 (bf16 converts with __bfloat162float) and
//   each of 256 threads keeps a 4 x TN register tile; it writes
//   partial[p, :] in fp32, the terms of each element added Cin-inner in one
//   fixed order by fmaf, as the OS kernel does.
//
//   pass B (ws_merge_kernel): one thread per (output row, channel),
//   neighbouring channels on neighbouring threads. From +0.0 it walks the
//   columns k in order and adds partial[pidx[i, k], c] where the pair was
//   kept. That is the reference's order (acc.at[out_idx].add(part), offset
//   after offset) with no atomics: a row's bits depend only on its own map
//   row, so a batch of B is bitwise equal to B single runs. Rows without
//   pairs (PAD rows included) come out +0.0.
//
// Bound on this card: operations for the 32- and 64-channel layers
// (2 * kept_pairs * Cin * Cout fp32 FMAs on CUDA cores; the contract is
// IEEE fp32, so no TF32), bytes for the stem (Cin = 5) and for the merge,
// which reads the [M, Ks] pair-index table. This first version stages
// through shared memory without cp.async, TMA or wgmma; one launch per
// layer covers every offset, so the host pays two kernel launches per
// layer rather than one per offset.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBP = 64;         // pairs per chunk (rows of a block tile)
constexpr int kBK = 16;         // Cin slice staged per step
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kTM = 4;          // pair rows per thread
constexpr int kMergeThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The offset whose chunks hold block b: the largest k < Ks with
// chunk_off[k] <= b (offsets without pairs own no chunk).
__device__ __forceinline__ int chunk_offset(const int32_t* chunk_off, int Ks,
                                            int b) {
  int lo = 0, hi = Ks - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (chunk_off[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <typename T, int TN>
__global__ void __launch_bounds__(kThreads)
ws_gemm_kernel(const T* __restrict__ F, int Cin,
               const int32_t* __restrict__ pin,
               const int32_t* __restrict__ cnt,
               const int32_t* __restrict__ choff,
               const int32_t* __restrict__ chunk_off, int Ks,
               const T* __restrict__ W, int Cout,
               float* __restrict__ partial) {
  constexpr int kBN = 16 * TN;
  __shared__ int k_s;
  __shared__ int idx_s[kBP];
  __shared__ float a_s[kBK][kBP + 1];   // gathered rows, channel-major
  __shared__ float b_s[kBK][kBN];
  if (threadIdx.x == 0) k_s = chunk_offset(chunk_off, Ks, blockIdx.x);
  __syncthreads();
  const int k = k_s;
  const int chunk = static_cast<int>(blockIdx.x) - chunk_off[k];
  const int p0 = choff[k] + chunk * kBP;
  const int p_end = choff[k] + cnt[k];
  const int rows = min(kBP, p_end - p0);
  const int t = static_cast<int>(threadIdx.x);
  if (t < kBP) idx_s[t] = t < rows ? pin[p0 + t] : -1;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int col0 = blockIdx.y * kBN;
  const T* wk = W + static_cast<size_t>(k) * Cin * Cout;
  float acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  __syncthreads();

  for (int c0 = 0; c0 < Cin; c0 += kBK) {
    for (int e = threadIdx.x; e < kBP * kBK; e += kThreads) {
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
      float a[kTM], b[TN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = a_s[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = b_s[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    float* dst = partial + static_cast<size_t>(p0 + r) * Cout;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = col0 + tx + 16 * j;
      if (n < Cout) dst[n] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kMergeThreads)
ws_merge_kernel(const float* __restrict__ partial,
                const int32_t* __restrict__ pidx, int M, int Ks, int Cout,
                float* __restrict__ out) {
  const size_t e = static_cast<size_t>(blockIdx.x) * kMergeThreads +
                   threadIdx.x;
  if (e >= static_cast<size_t>(M) * Cout) return;
  const size_t row = e / Cout;
  const int c = static_cast<int>(e - row * Cout);
  const int32_t* prow = pidx + row * Ks;
  float acc = 0.0f;
  for (int k = 0; k < Ks; ++k) {
    const int32_t p = prow[k];
    if (p >= 0) acc = acc + partial[static_cast<size_t>(p) * Cout + c];
  }
  out[e] = acc;
}

template <typename T, int TN>
cudaError_t launch_gemm(const void* F, int Cin, const void* pin,
                        const void* cnt, const void* choff,
                        const void* chunk_off, int Ks, int n_chunks,
                        const void* W, int Cout, void* partial,
                        cudaStream_t stream) {
  const dim3 grid(n_chunks, (Cout + 16 * TN - 1) / (16 * TN));
  ws_gemm_kernel<T, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(F), Cin, static_cast<const int32_t*>(pin),
      static_cast<const int32_t*>(cnt), static_cast<const int32_t*>(choff),
      static_cast<const int32_t*>(chunk_off), Ks, static_cast<const T*>(W),
      Cout, static_cast<float*>(partial));
  return cudaGetLastError();
}

template <typename T>
int launch(const void* F, int Cin, const void* pin, const void* cnt,
           const void* choff, const void* chunk_off, int Ks, int n_chunks,
           const void* W, int Cout, int tn, void* partial, const void* pidx,
           int M, void* out, void* stream) {
  if (M <= 0 || Cout <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0) {
    cudaError_t e;
    switch (tn) {
      case 1: e = launch_gemm<T, 1>(F, Cin, pin, cnt, choff, chunk_off, Ks,
                                    n_chunks, W, Cout, partial, s); break;
      case 2: e = launch_gemm<T, 2>(F, Cin, pin, cnt, choff, chunk_off, Ks,
                                    n_chunks, W, Cout, partial, s); break;
      case 4: e = launch_gemm<T, 4>(F, Cin, pin, cnt, choff, chunk_off, Ks,
                                    n_chunks, W, Cout, partial, s); break;
      default: return cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return e;
  }
  const size_t elems = static_cast<size_t>(M) * Cout;
  const unsigned blocks =
      static_cast<unsigned>((elems + kMergeThreads - 1) / kMergeThreads);
  ws_merge_kernel<<<blocks, kMergeThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const int32_t*>(pidx),
      M, Ks, Cout, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// F: [N, Cin]; W: [Ks, Cin, Cout] (one type, fp32 or bf16); pin: int32 [P];
// cnt, choff: int32 [Ks]; chunk_off: int32 [Ks + 1] with n_chunks =
// chunk_off[Ks]; tn: Cout tile / 16, one of 1, 2, 4; partial: fp32
// [P, Cout] scratch; pidx: int32 [M, Ks]; out: fp32 [M, Cout]. All
// contiguous.
extern "C" int spira_ws_scatter_gemm_f32(
    const void* F, int Cin, const void* pin, const void* cnt,
    const void* choff, const void* chunk_off, int Ks, int n_chunks,
    const void* W, int Cout, int tn, void* partial, const void* pidx, int M,
    void* out, void* stream) {
  return launch<float>(F, Cin, pin, cnt, choff, chunk_off, Ks, n_chunks, W,
                       Cout, tn, partial, pidx, M, out, stream);
}

extern "C" int spira_ws_scatter_gemm_bf16(
    const void* F, int Cin, const void* pin, const void* cnt,
    const void* choff, const void* chunk_off, int Ks, int n_chunks,
    const void* W, int Cout, int tn, void* partial, const void* pidx, int M,
    void* out, void* stream) {
  return launch<__nv_bfloat16>(F, Cin, pin, cnt, choff, chunk_off, Ks,
                               n_chunks, W, Cout, tn, partial, pidx, M, out,
                               stream);
}
