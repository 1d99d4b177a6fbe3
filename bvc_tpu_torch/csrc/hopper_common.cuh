// Hopper (sm_90a) building blocks in raw PTX: mbarriers, TMA tile loads,
// warpgroup matrix products (wgmma) on shared-memory operands, and register
// rebalancing between warpgroups.  Used by gemm.cu.
//
// Shared-memory operands are K-major tiles of 128-byte rows written by TMA
// with the 128-byte swizzle: 8-row atoms of 1024 bytes, so every tile must
// start on a 1024-byte boundary.  A wgmma k-step reads 32 bytes of each row
// (k32 for 8-bit types, k16 for bf16): the descriptor of k-step ks is the
// tile's descriptor with 2 ks added to its address field (32 bytes in units
// of 16), as the hardware applies the swizzle to the address it computes.

#pragma once

#include <cuda.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Spins until the barrier's phase with the given parity has completed.  A
// waiter may be at most one phase ahead of the barrier: parity cannot tell
// phase k from phase k + 2.  The loop stays inside the asm, so that the
// compiler sees no divergent path around the wgmma that follow.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

// One arrival, made by the threads whose `pred` is true (predicated inside
// the asm, again with no branch around it).
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(static_cast<uint32_t>(pred))
      : "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// ---- TMA -----------------------------------------------------------------

// The box of a 2-D tensor map at (inner, outer) into shared memory; the
// bytes complete a transaction on `bar`.  Parts of the box outside the
// tensor are filled with zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int inner,
                                            int outer, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(inner), "r"(outer),
         "r"(smem_addr(bar))
      : "memory");
}

// A box of shared memory to a 2-D tensor map at (inner, outer), issued by
// the threads whose `pred` is true into their current bulk group.  Parts of
// the box outside the tensor are not written.
__device__ __forceinline__ void tma_store_2d_if(const CUtensorMap* map, const void* src, int inner,
                                                int outer, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.u32 p, %4, 0;\n"
      "@p cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      "}\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(inner), "r"(outer),
         "r"(static_cast<uint32_t>(pred))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most kPending of this thread's bulk groups (TMA stores)
// are still reading their shared-memory source.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(kPending) : "memory");
}

// Waits until every bulk group of this thread has completed its writes.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy (TMA, bulk copy) reads of it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- register rebalancing ------------------------------------------------

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

// ---- wgmma ---------------------------------------------------------------

// Descriptor of a K-major, 128-byte-swizzled tile at shared address `addr`:
// rows 128 bytes apart, 8-row groups 1024 bytes apart (stride byte offset),
// leading byte offset unused for this layout (1, as by convention).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Pins accumulator registers at this point of the program, so that the
// compiler neither reads them before a wgmma_wait nor moves their writes
// past a wgmma_fence.
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most kPending committed groups of this warpgroup are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}

#define HOPPER_D8(C, i) \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define HOPPER_D64(C)                                                                 \
  HOPPER_D8(C, 0), HOPPER_D8(C, 8), HOPPER_D8(C, 16), HOPPER_D8(C, 24), HOPPER_D8(C, 32), \
      HOPPER_D8(C, 40), HOPPER_D8(C, 48), HOPPER_D8(C, 56)
#define HOPPER_S32(x) "+r"(x)
#define HOPPER_F32(x) "+f"(x)
#define HOPPER_D64_OPERANDS                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D [64 x 128] += A [64 x 32] B [128 x 32]^T, s8 operands from shared
// memory (descriptors), s32 accumulators: thread t of warp w holds rows
// 16 w + t / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1) in d[4 j .. 4 j + 3].
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " HOPPER_D64_OPERANDS
      ", %64, %65, p;\n"
      "}\n"
      : HOPPER_D64(HOPPER_S32)
      : "l"(a), "l"(b), "r"(1));
}

// The same for bf16 operands (16 elements of K per step), f32 accumulators;
// both operands K-major (no transpose), unit scales.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64_OPERANDS
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_D64(HOPPER_F32)
      : "l"(a), "l"(b), "r"(1));
}

#undef HOPPER_D8
#undef HOPPER_D64
#undef HOPPER_S32
#undef HOPPER_F32
#undef HOPPER_D64_OPERANDS

}  // namespace hopper
