// Hopper (sm_90a) warpgroup helpers for the port's attention kernels:
// `wgmma.mma_async` products of a 64-row tile by the four warps of a
// warpgroup (bf16 in, float32 accumulate), tiles brought into shared memory
// by the Tensor Memory Accelerator (TMA) with completion reported to an
// `mbarrier`, and the fences and barriers between them.
//
// Shared tiles are written by TMA with 128-byte swizzling: a tile is cut
// into blocks of 64 bf16 columns, each [rows][64] block a 1024-byte-aligned
// run of 128-byte rows, in which the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8) (`swz`). A descriptor (`desc`) hands such a block to wgmma:
//   K-major (rows are M or N, the 64 columns the reduction): 8-row groups
//     1024 bytes apart; a k-step of 16 columns starts 32 bytes further on;
//   MN-major (rows are the reduction, the 64 columns M or N): the same
//     bytes read across; a k-step of 16 rows starts 2048 bytes further on,
//     and an operand wider than 64 columns steps to the next block by the
//     leading offset; one 32 columns wide may start 64 bytes into a row
//     (the swizzle acts on the address bits, so it reads through).
// Accumulator of m64nNk16 (float32, thread l of warp w of the warpgroup,
// g = l / 4, t = l % 4): d[j][c] = (row 16 w + g + 8 (c / 2), column 8 j +
// 2 t + c % 2), the layout of mma_tile's C fragments repeated over N / 8
// n-tiles; so mma_tile `acc_to_a` of n-tiles 2 kk and 2 kk + 1 is the
// register A operand of k-step kk.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace wgmma_tile {

using mma_tile::smem_u32;

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled block
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// wgmma descriptor of a 128-byte-swizzled operand at p: leading and stride
// byte offsets as above (K-major: lbo unused, 16)
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | uint64_t((lbo >> 4) & 0x3FFF) << 16 |
         uint64_t((sbo >> 4) & 0x3FFF) << 32 | uint64_t(1) << 62;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the TMA unit
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival, and `bytes` more that the phase waits for from TMA
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// box (c0, c1, c2) of a 3-d tensor map into shared memory, its bytes
// reported to bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// this thread's shared-memory writes become visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` (1-15) over `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers in place around a wgmma wait, so that the
// compiler neither reads them before the wait nor moves them while a
// product is in flight
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+f"(d[i][c])::"memory");
}

// d (+)= A B, m64n64k16, A and B from shared memory: TA / TB 1 for an
// MN-major operand; accumulate 0 overwrites d
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (+)= A B, m64n32k16, A and B from shared memory: TA / TB 1 for an
// MN-major operand; accumulate 0 overwrites d
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_n32(float (&d)[4][4], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d += A B, m64n64k16, A from registers (bf16 pairs in the accumulator's
// layout), B from shared memory (TB 1: MN-major)
template <int TB>
__device__ __forceinline__ void mma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

}  // namespace wgmma_tile
