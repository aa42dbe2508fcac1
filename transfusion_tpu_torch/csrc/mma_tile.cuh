// Tensor-core and async-copy helpers for the port's bf16 attention kernels
// on Hopper (sm_90a): warp-level `mma.sync` m16n8k16 (bf16 in, float32
// accumulate), `ldmatrix` to feed it from shared memory, `cp.async` to fill
// shared memory from device memory without holding registers.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..2t+1),
//                           a[2] = (g, 2t+8..2t+9), a[3] = (g+8, 2t+8..2t+9)
//   B (16 x 8, k x n):      b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8..2t+9, n g)
//   C (16 x 8, float32):    c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1)
// Two bf16 share a 32-bit register, the lower column in the low half. So the
// C fragments of two neighbouring n-tiles, rounded to bf16, are the A
// fragment of a k-step of 16 (`acc_to_a`): FlashAttention-2's register reuse.
//
// Tiles in shared memory are row-major bf16 with a row stride of
// (cols + 8) elements: the 16-byte pad puts the 8 rows that one ldmatrix
// phase reads on 8 different groups of 4 banks, for widths of 32, 64 and
// 128 columns, in plain and transposed reads alike.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_tile {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and receives element (l / 4, 2 (l % 4) .. +1) of each matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same, each matrix transposed: lane l receives elements
// (2 (l % 4) .. +1, l / 4) of each matrix as stored.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Lane addresses of the x4 loads of one 16 x 16 block at (r0, c0) of a
// tile of row stride ld. `ldsm_rows` orders the four 8x8 matrices down the
// rows first ((r0, c0), (r0+8, c0), (r0, c0+8), (r0+8, c0+8)): with
// ldsm_x4 it gives the A fragment of a tile stored [m][k]; with ldsm_x4_t
// the B fragments of a tile stored [k][n], n-tile c0 in r[0..1] and c0+8 in
// r[2..3]. `ldsm_cols` orders them across the columns first ((r0, c0),
// (r0, c0+8), (r0+8, c0), (r0+8, c0+8)): with ldsm_x4 it gives the B
// fragments of a tile stored [n][k], n-tile r0 in r[0..1] and r0+8 in
// r[2..3]; with ldsm_x4_t the A fragment of a tile stored [k][m].
template <typename T>
__device__ __forceinline__ const T* ldsm_rows(const T* tile, int ld, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}
template <typename T>
__device__ __forceinline__ const T* ldsm_cols(const T* tile, int ld, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 7) + (lane >> 4) * 8) * ld + c0 + ((lane >> 3) & 1) * 8;
}

// c += a b on the tensor cores (16 x 8 x 16, bf16 operands, float32 sums)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  __nv_bfloat162 v;
  *reinterpret_cast<uint32_t*>(&v) = x;
  return __bfloat1622float2(v);
}

// The A fragment of k-step kk from the C fragments of n-tiles 2kk, 2kk+1
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 16 bytes from device to shared memory, asynchronously (L2 only); with
// valid = false no byte is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// *p += (x, y) as one 8-byte atomic (sm_90's vector atomicAdd; p 8-byte
// aligned, device memory). The order of the additions varies between runs.
__device__ __forceinline__ void atomic_add2(float* p, float x, float y) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(x, y));
}

}  // namespace mma_tile
