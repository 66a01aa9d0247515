// Hopper (sm_90a) pieces of the bf16 kernels, as inline PTX: mbarriers, the
// async-proxy fence, ldmatrix / stmatrix, a zero-filling partial copy, and
// the warpgroup matrix multiply (wgmma) on bf16 operands in
// 128-byte-swizzled shared memory.
//
// Operand tiles for wgmma. Both operands are K-major: a row (an output pixel
// of A, an output channel of B) holds 64 consecutive K values, 128 bytes,
// and 16-byte unit u of row r is stored at r * 128 + ((u ^ (r % 8)) * 16)
// from a 1024-byte-aligned tile base (the 128-byte swizzle, which spreads the
// eight rows of a unit column over all banks). A descriptor names such a
// tile with its 8-row groups 1024 bytes apart (SBO); the k-th 16-deep slice
// of the 64 starts 32 * k bytes further, since the hardware applies the swizzle
// to the address bits it forms.

#pragma once

#include <stdint.h>

#include "gdn_epilogue.cuh"

namespace iclr17c {

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the other threads (and to
// the copy hardware); a __syncthreads() follows it.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival, with release semantics for the thread's earlier writes.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival, made by the hardware once every cp.async the thread has
// issued so far has landed (the barrier's count includes it: .noinc).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A ring
// waits microseconds; a wait of 2^24 tries (a second or more) means a broken ring,
// and the kernel traps (a launch failure the wrapper reports) instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 24)) asm volatile("trap;");
  }
}

// Orders the generic-proxy writes this thread can see (cp.async and
// st.shared tiles, published to it through an mbarrier) before its
// following async-proxy reads (wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four 8x8 b16 matrices from shared memory (lane l gives the address of row
// l % 8 of matrix l / 8); with trans, each is transposed on the way.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// ldmatrix_x4's inverse: four 8x8 b16 matrices from the fragment layout to
// shared memory, lane l giving the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void stmatrix_x4(void* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_u32(p)),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// A 16-byte copy to shared memory of which only the first `bytes` (0 to
// 16) are read; the rest of the 16 is zero-filled.
__device__ __forceinline__ void cp_async16_part(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// The descriptor of a K-major, 128-byte-swizzled operand tile at shared
// address `addr`: start address >> 4, leading offset 16 bytes (not read in
// this mode), stride offset 1024 bytes (8 rows of 128), layout 1 (128B).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma fence or wait (the products write them asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A . B + (scale_d ? d : 0) for a 64 x 16 bf16 A and a 16 x 64 bf16 B,
// both K-major in shared memory (descriptors da, db), fp32 accumulators in
// the m64n64 fragment layout: register 4j + r of the thread at lane (g, t)
// of warp w of the warpgroup is row 16w + g + 8 * (r >= 2), column 8j + 2t
// + (r & 1).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

}  // namespace iclr17c
