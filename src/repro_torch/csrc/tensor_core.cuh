// Warp-level tensor-core and async-copy building blocks shared by the
// mma.sync kernels (spconv_gather_gemm.cu, dw_gather_gemm.cu,
// flash_attention.cu) and the segment sum's cp.async ring: cp.async
// with zero fill, ldmatrix (plain and transposed), mma.sync m16n8k16 bf16
// and m16n8k8 tf32 with fp32 accumulators, and the round-to-nearest tf32
// split that 3xTF32 needs. sm_80 instructions, all valid on sm_90a. Also
// the row-gather helpers of the two gather-GEMMs (the copy of one chunk,
// a thread's walk over a tile's copies, the widest copy a row allows) and
// the card's SM count.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace spira_tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `Bytes` (4, 8 or 16) from global to shared memory asynchronously;
// with `valid` false nothing is read and the destination is zero-filled
// (src-size 0). Both addresses must be `Bytes`-aligned.
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  static_assert(Bytes == 4 || Bytes == 8 || Bytes == 16, "cp.async size");
  const uint32_t d = smem_u32(dst);
  const int n = valid ? Bytes : 0;
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(Bytes), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a . b over a 16x8x16 bf16 tile, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b over a 16x8x8 tf32 tile, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 explicit mantissa bits), to nearest, ties away
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (a remainder below 2^-22 |x|): hi = rna(x), lo = rna(x - hi);
// x - hi is exact in fp32
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One chunk of `vec` bytes (16, 8, 4, or 2 by plain loads) into shared
// memory, zeros when `valid` is false.
__device__ __forceinline__ void copy_chunk(char* dst, const char* src,
                                           bool valid, int vec) {
  switch (vec) {
    case 16: cp_async<16>(dst, src, valid); break;
    case 8: cp_async<8>(dst, src, valid); break;
    case 4: cp_async<4>(dst, src, valid); break;
    default:
      *reinterpret_cast<uint16_t*>(dst) =
          valid ? *reinterpret_cast<const uint16_t*>(src) : uint16_t{0};
  }
}

// A thread's walk over a tile's copies, rows of `chunks` copies, in a block
// of `Threads`: its first (row, chunk) and the step between its copies, so
// the copy loops need no division.
struct Walk {
  int r0, c0, dr, dc, chunks;
};

template <int Threads>
__device__ __forceinline__ Walk make_walk(int chunks) {
  return Walk{static_cast<int>(threadIdx.x) / chunks,
              static_cast<int>(threadIdx.x) % chunks, Threads / chunks,
              Threads % chunks, chunks};
}

// The widest copy (16, 8, 4 or 2 bytes) that divides a row of `row_bytes`
// and the base address, at least one element.
inline int copy_bytes(const void* p, int64_t row_bytes, int elem) {
  const auto addr = reinterpret_cast<uintptr_t>(p);
  for (int v = 16; v > elem; v /= 2)
    if (row_bytes % v == 0 && addr % v == 0) return v;
  return elem;
}

// SMs of the current device (132 on an H100 SXM if the query fails).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

}  // namespace spira_tc
