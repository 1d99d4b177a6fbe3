// Tiles, copies and tensor-core products shared by the flash-attention
// kernels of flash_fwd.cu and flash_bwd.cu (bf16, sm_90a), templated on the
// head width D (64 or 32).
//
// Every kernel runs one CTA of 4 warps over a 64-row tile and walks the
// other side of the attention in 64-row tiles.  Rows of the shared tiles
// are padded by 8 bf16 (16 bytes): 144-byte rows at D = 64 and 80-byte rows
// at D = 32, both of which spread the fragment loads and the ldmatrix rows
// of a warp over all 32 banks.  Products run on mma.sync.m16n8k16 (bf16 in,
// f32 accumulate), D / 16 k-steps over the head width; in the accumulator's
// register layout thread (g, t) of a warp (g = lane / 4, t = lane % 4)
// holds rows g and g + 8 and columns 2t and 2t + 1 of each 8-column block,
// which is also the A-operand layout of a following product, so a score
// tile goes from accumulators to the tensor cores without a trip through
// shared memory.
//
// Key bias: the masked kernels add a per-sample row of f32 key biases
// (0 for a key that may be attended, -1e30 for a masked one) to every
// score of the key's column; add_bias does it from a shared 64-entry
// slice, load_bias fetches that slice.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kBlockM = 64;  // rows of the CTA's own tile, 16 per warp
constexpr int kBlockN = 64;  // rows of each streamed tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowPad = 8;  // bf16 elements of padding per shared row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;
template <int D>
using Tile = bf16[kBlockN][D + kRowPad];

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4-byte asynchronous copy (one f32); zero-fills when !valid.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Rows [row0, row0 + 64) of one (batch, head) slice into a shared tile;
// rows at or beyond n are zero-filled.  D / 8 threads cover one row of
// 16-byte chunks, so each warp reads 256 / D whole rows per pass.
template <int D>
__device__ __forceinline__ void load_tile(Tile<D>& dst, const bf16* base, long long row0,
                                          int n, long long row_stride) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int it = 0; it < kBlockN * kChunks / kThreads; ++it) {
    // unsigned, so that / and % by the power of two are a shift and a mask
    const unsigned i = threadIdx.x + it * kThreads;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const long long row = row0 + r;
    const bool valid = row < n;
    cp_async_16(&dst[r][c], base + (valid ? row : 0) * row_stride + c, valid);
  }
}

// Key biases [col0, col0 + 64) of one batch element's [n] row into shared
// memory, one f32 per thread of the first 64; columns at or beyond n are
// zero-filled (the caller masks them in the scores).
__device__ __forceinline__ void load_bias(float (&dst)[kBlockN], const float* row,
                                          long long col0, int n) {
  if (threadIdx.x < kBlockN) {
    const long long col = col0 + threadIdx.x;
    const bool valid = col < n;
    cp_async_4(&dst[threadIdx.x], row + (valid ? col : 0), valid);
  }
}

__device__ __forceinline__ uint32_t ld_shared_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 bf16 matrices, transposed on the way: feeds a row-major
// [k][n] tile (V in P.V, K in dS.K, dO in P^T.dO, Qs in dS^T.Qs) as the B
// operand.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// D += A (16x16, row-major) * B (16x8, column-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A-operand fragments of this warp's 16 rows of a shared tile, over the
// whole head width: frag[ks] covers columns [16 ks, 16 ks + 16).
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&frag)[D / 16][4], const Tile<D>& tile,
                                             int warp, int lane) {
  const int r = warp * 16 + (lane >> 2);
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    frag[ks][0] = ld_shared_u32(&tile[r][ks * 16 + c]);
    frag[ks][1] = ld_shared_u32(&tile[r + 8][ks * 16 + c]);
    frag[ks][2] = ld_shared_u32(&tile[r][ks * 16 + 8 + c]);
    frag[ks][3] = ld_shared_u32(&tile[r + 8][ks * 16 + 8 + c]);
  }
}

// acc[16 x 64] = A (this warp's 16 rows, as fragments) times B^T, where B
// is a row-major [64 rows][D] shared tile: the score products
// S = Qs K^T, dP = dO V^T, S^T = K Qs^T and dP^T = V dO^T.
template <int D>
__device__ __forceinline__ void product_abt(float (&acc)[kBlockN / 8][4],
                                            const uint32_t (&a)[D / 16][4],
                                            const Tile<D>& b, int lane) {
  const int g = lane >> 2;
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const bf16* br = &b[nt * 8 + g][ks * 16 + c];
      mma_16816(acc[nt], a[ks], ld_shared_u32(br), ld_shared_u32(br + 8));
    }
  }
}

// acc[16 x D] += P B, with P the warp's [16 x 64] f32 score tile in
// accumulator registers, rounded to bf16 on the way into the A operand,
// and B a row-major [64][D] shared tile: O += P V, dQ += dS K,
// dV += P^T dO and dK += dS^T Qs.
template <int D>
__device__ __forceinline__ void product_pb(float (&acc)[D / 8][4],
                                           const float (&p)[kBlockN / 8][4],
                                           const Tile<D>& b, int lane) {
#pragma unroll
  for (int ks = 0; ks < kBlockN / 16; ++ks) {
    const uint32_t a[4] = {
        pack_bf16(p[2 * ks][0], p[2 * ks][1]),
        pack_bf16(p[2 * ks][2], p[2 * ks][3]),
        pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]),
        pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3]),
    };
    const int row = ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, &b[row][dp * 16 + (lane >> 4) * 8]);
      mma_16816(acc[2 * dp], a, r[0], r[1]);
      mma_16816(acc[2 * dp + 1], a, r[2], r[3]);
    }
  }
}

// The ragged last tile: entries of a score tile whose column (col0 plus
// the column in the tile) is at or beyond n are set to `fill`.
__device__ __forceinline__ void fill_cols_from(float (&s)[kBlockN / 8][4], long long col0,
                                               int n, int lane, float fill) {
  if (col0 + kBlockN <= n) return;
#pragma unroll
  for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (col0 + nt * 8 + 2 * (lane & 3) + (c & 1) >= n) s[nt][c] = fill;
    }
  }
}

// s += the key bias of each score's column, from a shared 64-entry slice.
__device__ __forceinline__ void add_bias(float (&s)[kBlockN / 8][4],
                                         const float (&bias)[kBlockN], int lane) {
#pragma unroll
  for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[nt][c] += bias[nt * 8 + 2 * (lane & 3) + (c & 1)];
  }
}

// Store this warp's [16 x D] f32 accumulator as bf16 rows of a
// [.., n, .., D] tensor (row stride in elements); rows at or beyond n are
// skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride, long long row0,
                                           int n, const float (&acc)[D / 8][4], int warp,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = row0 + warp * 16 + (lane >> 2) + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(base + row * row_stride + nt * 8 + 2 * (lane & 3)) =
          pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
  }
}

}  // namespace flash
