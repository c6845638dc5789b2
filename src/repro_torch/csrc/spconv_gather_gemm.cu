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
//    use it (in row order) with their input rows, by ballots. An offset no
//    row uses issues no copy and no mma; an offset used by c rows runs
//    ceil(c / 16) 16-row mma fragments instead of 8. At full resolution
//    that is 2.1x the useful products against 12.8x for the whole tile
//    (MinkUNet-42's outdoor scenes).
//  * The sweep over a chunk's packed lists is gather_mma.cuh's run_chunk,
//    shared with the WS sweep: K-steps over (offset with rows, pass of up
//    to 64 packed rows, Cin slice of 128 bytes: 64 bf16 or 32 fp32) in a
//    2-stage cp.async pipeline, the pass's input rows and W[k]'s slice of
//    step s + 1 loading while step s multiplies. At full resolution a step
//    has a few rows and its time is the latency of those loads, so the
//    design keeps steps few and wide and two blocks on an SM (the 64-row
//    pass, 2 stages and 16-offset chunks keep a 96-column block at 106 KB
//    of shared memory). Fragments, copies, and the arithmetic: bf16
//    m16n8k16 with exact products; fp32 3xTF32 on m16n8k8, each 16
//    channels summed into a zeroed fragment and added by one fp32 add,
//    because the tensor cores' accumulate truncates (over the ~1,000 mma
//    of a Kd = 125 layer it drifts by ~1e-5 relative). The sums keep the
//    accuracy of an fp32 sum (chip_smoke holds every fp32 launch against a
//    float64 reference) at a third of the TF32 rate. Plain TF32 would keep
//    ~3 decimal digits and break the IEEE-fp32 reference contract.
//
// Add order (gather_mma.cuh): per output element one fp32 accumulator,
// each offset's sum over the Cin slices added to it once, offsets in
// order; a sum depends only on the element's own input row and W. The
// tile shape does not depend on M, so a row's bits depend on nothing but
// its own map row: a batch of B is bitwise equal to B single runs. No
// split-K, no atomics. The output is written in the input's type.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gather_mma.cuh"

namespace {

using namespace spira_gm;

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
os_mma_kernel(const T* __restrict__ F, int Cin,
              const int32_t* __restrict__ m, int M, int Kd,
              const T* __restrict__ W, int Cout, T* __restrict__ out,
              int n_col_tiles, int vecA, int vecB) {
  using L = Tile<T, BN>;
  extern __shared__ __align__(16) char smem[];
  int* idx_s = reinterpret_cast<int*>(smem + L::kMapOffset);  // [kKC][kLdIdx]
  uint8_t* rows_s = reinterpret_cast<uint8_t*>(smem + L::kRowsOffset);
  int* cnt_s = reinterpret_cast<int*>(smem + L::kListOffset);  // [kKC]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x / n_col_tiles) * kBM;
  const int n0 = (blockIdx.x % n_col_tiles) * BN;
  const Walk wb =
      make_walk<kThreads>(BN * static_cast<int>(sizeof(T)) / vecB);

  clear_acc<T, BN>(smem);
  for (int kc0 = 0; kc0 < Kd; kc0 += kKC) {
    const int kcn = min(kKC, Kd - kc0);
    __syncthreads();           // the last chunk's map and lists are done with
    {
      const int r = threadIdx.x % kBM;
      const int row = row0 + r;
      const int32_t* mr = m + static_cast<int64_t>(row) * Kd + kc0;
      for (int kk = threadIdx.x / kBM; kk < kcn; kk += kThreads / kBM)
        idx_s[kk * L::kLdIdx + r] = row < M ? mr[kk] : -1;
    }
    __syncthreads();
    // per offset, the tile rows that use it and their inputs, packed in
    // row order (in place: a row's packed position is never past it)
    for (int kk = warp; kk < kcn; kk += kWarps) {
      int* col = idx_s + kk * L::kLdIdx;
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
    run_chunk<T, BN>(smem, F, Cin,
                     W + static_cast<int64_t>(kc0) * Cin * Cout, Cout, kcn,
                     n0, vecA, wb);
  }
  store_tile<T, BN>(smem, out, row0, M, n0, Cout);
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
