// Building blocks of the port's bf16 tensor-core kernels for Hopper
// (sm_90a): 16-byte asynchronous copies into shared memory, ldmatrix
// fragment loads, the mma.sync m16n8k16 and wgmma m64n128k16 bf16 -> fp32
// products, and the XOR swizzle that keeps copies and reads
// conflict-free (for rows of 128 bytes it is wgmma's 128-byte swizzle).
//
// Fragments of mma.sync.m16n8k16.row.col (lane = 4 g + t):
// * A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..),
//   a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..);
// * B (16 x 8, k x n): b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., n g);
// * C/D (16 x 8, fp32): c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..).
// ldmatrix.x4 loads four 8 x 8 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i of every lane receives matrix i
// in the A/B fragment order above (.trans transposes each matrix).
//
// Tiles in shared memory are rows of 16-byte chunks.  ldmatrix reads one
// chunk from each of 8 rows; swizzle() moves a row's chunks so those 8
// chunks fall in 8 different 16-byte bank groups whatever the row width
// (2, 4, or >= 8 chunks), and cp.async writes them in the same places.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `full` false writes 16 zero
// bytes and reads nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a * b on the tensor cores: bf16 operands, fp32 accumulator (no
// memory access, so not volatile: the compiler may interleave it with
// the fragment loads around it)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma: one warpgroup (4 warps, 128 threads) multiplies a 64 x 16 tile
// of A by a 16 x 128 tile of B, both read from shared memory through
// descriptors, into 64 fp32 accumulators a thread (the mma.sync C layout
// above for n8 tiles j = 0..15: d[4j..4j+3], warp w of the warpgroup
// holding rows 16w + g and 16w + g + 8).  A is K-major, B MN-major
// (imm-trans-b 1: rows of w with N contiguous); both 128-byte swizzled.

// descriptor of a 128-byte-swizzled operand at `addr` (1024-byte aligned
// swizzle atoms of 8 rows x 128 bytes): lbo and sbo in bytes
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
      | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
      | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
      | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until the warpgroup's committed wgmma groups are done
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// make this thread's generic-proxy writes to shared memory (cp.async
// copies that have landed) visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += A (64 x 16, K-major) * B (16 x 128, MN-major), bf16 in, fp32 out
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

// 2^x on the special-function unit, denormal results flushed to zero
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// where chunk `chunk` of row `row` sits in a row of kChunks 16-byte chunks
template <int kChunks>
__device__ __forceinline__ int swizzle(int row, int chunk) {
  if constexpr (kChunks >= 8) {
    return chunk ^ (row & 7);             // 8 rows: 8 chunks of one line
  } else if constexpr (kChunks == 4) {
    return chunk ^ ((row >> 1) & 3);      // 2 rows per 128-byte line
  } else if constexpr (kChunks == 2) {
    return chunk ^ ((row >> 2) & 1);      // 4 rows per 128-byte line
  } else {
    return chunk;
  }
}

// byte offset of (row, chunk) in a tile of kChunks chunks per row
template <int kChunks>
__device__ __forceinline__ uint32_t tile_offset(int row, int chunk) {
  return static_cast<uint32_t>((row * kChunks + swizzle<kChunks>(row, chunk))
                               * 16);
}

}  // namespace tc
