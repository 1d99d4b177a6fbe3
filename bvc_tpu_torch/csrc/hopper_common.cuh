// Hopper (sm_90a) building blocks in raw PTX: mbarriers, named barriers,
// TMA tile loads and stores (2-D and 4-D), warpgroup matrix products (wgmma)
// on shared-memory operands or with A in registers, and register
// rebalancing between warpgroups.  Used by gemm.cu and, through
// attn_sm90.cuh, by flash_fwd.cu, flash_bwd_sm90.cu and softmax_probe.cu.
//
// Shared-memory operands are tiles of 128-byte rows written by TMA with the
// 128-byte swizzle: 8-row atoms of 1024 bytes, so every tile must start on a
// 1024-byte boundary.  (At head width 32 a bf16 row is 64 bytes: the same
// rules hold with the 64-byte swizzle, 8-row atoms of 512 bytes, 16 k-rows
// 1024 bytes apart; desc_sw<64> and swizzle<64> below.)  A K-major operand (K along the row): a wgmma k-step
// reads 32 bytes of each row (k32 for 8-bit types, k16 for bf16), and the
// descriptor of k-step ks is the tile's descriptor with 2 ks added to its
// address field (32 bytes in units of 16), as the hardware applies the
// swizzle to the address it computes.  An MN-major operand (N along the
// row, K down the rows, as V is in O += P V): the same descriptor, whose
// stride byte offset (1024) now steps between 8-row groups along K, and a
// k16 step is 16 rows, 2048 bytes further; its leading byte offset would
// step between 64-wide swizzle atoms along N and is unused at N <= 64.  An
// MN-major operand narrower than the atom (N = 32, half of a 128-byte row)
// starts at its byte offset within the row, as a K-major k-step does.

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

// The box of a 4-D tensor map at (c0, c1, c2, c3), innermost first, into
// shared memory, as tma_load_2d.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// A box of shared memory to a 4-D tensor map at (c0, c1, c2, c3), as
// tma_store_2d_if.
__device__ __forceinline__ void tma_store_4d_if(const CUtensorMap* map, const void* src, int c0,
                                                int c1, int c2, int c3, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.u32 p, %6, 0;\n"
      "@p cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "}\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(static_cast<uint32_t>(pred))
      : "memory");
}

// A box of shared memory added element-wise into a 2-D tensor map at
// (inner, outer) (a TMA reduction, done in L2), issued by the threads whose
// `pred` is true into their current bulk group.  Parts of the box outside
// the tensor are not written.
__device__ __forceinline__ void tma_reduce_add_2d_if(const CUtensorMap* map, const void* src,
                                                     int inner, int outer, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.u32 p, %4, 0;\n"
      "@p cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.tile.bulk_group"
      " [%0, {%2, %3}], [%1];\n"
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

// ---- named barriers --------------------------------------------------------

// Waits at barrier `id` until `kCount` threads have reached it (this one
// included), counting those that only arrive.
template <int kCount>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(kCount) : "memory");
}

// Counts towards barrier `id` without waiting, for the threads whose
// `pred` is true (predicated inside the asm, with no branch around it).
template <int kCount>
__device__ __forceinline__ void bar_arrive_if(int id, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.u32 p, %2, 0;\n"
      "@p bar.arrive %0, %1;\n"
      "}\n"
      :: "r"(id), "n"(kCount), "r"(static_cast<uint32_t>(pred))
      : "memory");
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

// The same for rows of kRowBytes (128 or 64) with their own swizzle: 8-row
// groups 8 kRowBytes apart, layout type 1 (128-byte) or 2 (64-byte).
template <int kRowBytes>
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr) {
  static_assert(kRowBytes == 128 || kRowBytes == 64, "128- or 64-byte rows");
  if constexpr (kRowBytes == 128) {
    return desc_sw128(addr);
  } else {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
           (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
  }
}

// Where byte `offset` of a tile of kRowBytes-byte rows (128 or 64) lies
// under the matching TMA swizzle: its 16-byte chunk index XORed with the
// offset's bits 7 and up (row % 8 for 128-byte rows, row / 2 % 4 for 64).
template <int kRowBytes>
__device__ __forceinline__ int swizzle(int offset) {
  return offset ^ (((offset >> 7) & (kRowBytes / 16 - 1)) << 4);
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

// The same for an m64n64 accumulator, and for A fragments held in
// registers: fenced after a wgmma_wait, they stay live (and unclobbered)
// until the products that read them have retired.
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_operands(uint32_t (&a)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// The same for an m64n32 accumulator and for 16 A fragments (four k-steps).
__device__ __forceinline__ void fence_operands(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_operands(uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// The same for an m64n16 accumulator and for 8 A fragments (two k-steps).
__device__ __forceinline__ void fence_operands(float (&d)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_operands(uint32_t (&a)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) asm volatile("" : "+r"(a[i])::"memory");
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
// both operands K-major (no transpose), unit scales.  accumulate = false
// overwrites d with the product (the first k-step of a fresh sum).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                 bool accumulate = true) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64_OPERANDS
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_D64(HOPPER_F32)
      : "l"(a), "l"(b), "r"(static_cast<uint32_t>(accumulate)));
}

#define HOPPER_D32(C) HOPPER_D8(C, 0), HOPPER_D8(C, 8), HOPPER_D8(C, 16), HOPPER_D8(C, 24)
#define HOPPER_D32_OPERANDS                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"

// D [64 x 64] += A [64 x 16] B [16 x 64], bf16 operands, f32 accumulators,
// with A in registers and B an MN-major (transposed) shared-memory tile:
// thread t of warp w holds A's rows 16 w + t / 4 (+ 8) and columns
// 2 (t % 4) (+ 1) and (+ 8) as mma.sync.m16n8k16 does, packed in a0..a3,
// which is the layout of two adjacent 8-column blocks of an accumulator.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_OPERANDS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_D32(HOPPER_F32)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D [64 x 64] (+)= A [64 x 16] B [64 x 16]^T, bf16 operands, f32
// accumulators, with A in registers (as wgmma_m64n64k16_rs) and B K-major in
// shared memory; accumulate = false overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_rs_kmajor(float (&d)[32], uint32_t a0,
                                                          uint32_t a1, uint32_t a2, uint32_t a3,
                                                          uint64_t b, bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_OPERANDS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : HOPPER_D32(HOPPER_F32)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(static_cast<uint32_t>(accumulate)));
}

#define HOPPER_D16(C) HOPPER_D8(C, 0), HOPPER_D8(C, 8)

// D [64 x 32] (+)= A [64 x 16] B [16 x 32], bf16 operands from shared
// memory, both MN-major (transposed: A stored K x M, B stored K x N, as
// the V tile is in O += P V), f32 accumulators; accumulate = false
// overwrites d.
__device__ __forceinline__ void wgmma_m64n32k16_tt(float (&d)[16], uint64_t a, uint64_t b,
                                                   bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 1, 1;\n"
      "}\n"
      : HOPPER_D16(HOPPER_F32)
      : "l"(a), "l"(b), "r"(static_cast<uint32_t>(accumulate)));
}

// D [64 x 32] += A [64 x 16] B [16 x 32], bf16, f32 accumulators, with A
// in registers (as wgmma_m64n64k16_rs) and B MN-major in shared memory: the
// m64n32 counterpart of wgmma_m64n64k16_rs, for head width 32.
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_D16(HOPPER_F32)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D [64 x 16] (+)= A [64 x 16] B [16 x 16], bf16 operands from shared
// memory, both MN-major, f32 accumulators (wgmma_m64n32k16_tt at half the
// width); accumulate = false overwrites d.
__device__ __forceinline__ void wgmma_m64n16k16_tt(float (&d)[8], uint64_t a, uint64_t b,
                                                   bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", %8, %9, p, 1, 1, 1, 1;\n"
      "}\n"
      : HOPPER_D8(HOPPER_F32, 0)
      : "l"(a), "l"(b), "r"(static_cast<uint32_t>(accumulate)));
}

#undef HOPPER_D16
#undef HOPPER_D8
#undef HOPPER_D32
#undef HOPPER_D64
#undef HOPPER_S32
#undef HOPPER_F32
#undef HOPPER_D32_OPERANDS
#undef HOPPER_D64_OPERANDS

}  // namespace hopper
