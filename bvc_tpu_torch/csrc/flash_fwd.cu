// Forward flash attention for Hopper (sm_90a): bf16 queries, keys and values
// of head width 64, bf16 output and f32 log-sum-exp.
//
// Replaces bvc_tpu/ops/flash_attention.py::_fwd_kernel (launched from _fwd).
// Same arithmetic: non-causal attention over PRE-SCALED queries (the softmax
// scale is applied by the caller), online softmax with a running max m and a
// running sum l in f32, P rounded to bf16 before the P.V product, f32
// accumulation, O = acc / l in bf16 and LSE = m + log(l) in f32.  Key columns
// at or beyond N get -1e30, as _kmask does; query rows at or beyond N are
// computed on zero-filled rows and never stored.  The TPU's lane padding of
// LSE to 8 is dropped: LSE is [B, h, N].
//
// Bound.  At the extraction shape [B, 1568, 12, 64] the work per clip is
// 4*h*N^2*d = 7.55 GFLOP of tensor-core products (7.6 us at 989 TFLOP/s)
// against 9.6 MB of q/k/v/o traffic (2.9 us at 3.35 TB/s) and 29.5 M
// exponentials: the kernel is bound by operations, not bytes.
//
// Design.  One CTA of 4 warps per (64-row query tile, head, batch element);
// each warp owns 16 query rows.  The CTA walks the keys in tiles of 64:
// K and V tiles are double-buffered in shared memory with cp.async, so the
// next tile streams in while the tensor cores work on the current one, and
// the N x N scores never leave registers.  Both products run on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate); the S accumulator's register
// layout is the A-operand layout of the P.V product, so P goes from
// registers to the tensor cores with no trip through shared memory.  Rows of
// the shared tiles are padded from 128 to 144 bytes, which spreads the
// fragment loads of a warp over all 32 banks.  wgmma, TMA and warp
// specialisation are left for later work.
//
// The library has a plain C interface, loaded with ctypes: pointers and the
// stream are passed as void*, strides (in elements) as long long.  Each
// tensor is read through its strides; the innermost (head-width) stride must
// be 1 and every row must start on a 16-byte boundary, which the Python
// wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockM = 64;  // query rows per CTA, 16 per warp
constexpr int kBlockN = 64;  // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowStride = kHeadDim + 8;  // bf16 elements: 144-byte rows
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;
typedef bf16 Tile[kBlockN][kRowStride];

struct __align__(16) SharedTiles {
  Tile q;
  Tile k[2];
  Tile v[2];
};  // 5 * 64 * 72 * 2 = 46080 bytes, under the 48 KB static limit

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Rows [row0, row0 + 64) of one (batch, head) slice into a shared tile.
// 8 threads cover one 128-byte row, so each warp reads 4 whole rows.
__device__ __forceinline__ void load_tile(Tile& dst, const bf16* base, long long row0,
                                          int n, long long row_stride) {
#pragma unroll
  for (int it = 0; it < kBlockN * (kHeadDim / 8) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i >> 3;
    const int c = (i & 7) * 8;
    const long long row = row0 + r;
    const bool valid = row < n;
    cp_async_16(&dst[r][c], base + (valid ? row : 0) * row_stride + c, valid);
  }
}

__device__ __forceinline__ uint32_t ld_shared_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 bf16 matrices, transposed on the way: feeds V as the B operand.
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

__global__ void __launch_bounds__(kThreads)
flash_fwd_d64_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int n, int heads,
                     long long q_sb, long long q_sn, long long q_sh,
                     long long k_sb, long long k_sn, long long k_sh,
                     long long v_sb, long long v_sn, long long v_sh,
                     long long o_sb, long long o_sn, long long o_sh) {
  __shared__ SharedTiles sm;

  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const long long row0 = static_cast<long long>(blockIdx.x) * kBlockM;

  const bf16* qb = q + batch * q_sb + head * q_sh;
  const bf16* kb = k + batch * k_sb + head * k_sh;
  const bf16* vb = v + batch * v_sb + head * v_sh;

  load_tile(sm.q, qb, row0, n, q_sn);
  load_tile(sm.k[0], kb, 0, n, k_sn);
  load_tile(sm.v[0], vb, 0, n, v_sn);
  cp_async_commit();

  // This thread's rows of the warp's 16: r = 0 is row g, r = 1 is row g + 8.
  uint32_t qf[kHeadDim / 16][4];
  float acc[kHeadDim / 8][4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
  }

  const int num_tiles = (n + kBlockN - 1) / kBlockN;
  for (int j = 0; j < num_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < num_tiles) {
      load_tile(sm.k[buf ^ 1], kb, static_cast<long long>(j + 1) * kBlockN, n, k_sn);
      load_tile(sm.v[buf ^ 1], vb, static_cast<long long>(j + 1) * kBlockN, n, v_sn);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just requested has landed
    __syncthreads();

    if (j == 0) {
      const int qr = warp * 16 + g;
#pragma unroll
      for (int ks = 0; ks < kHeadDim / 16; ++ks) {
        qf[ks][0] = ld_shared_u32(&sm.q[qr][ks * 16 + 2 * t]);
        qf[ks][1] = ld_shared_u32(&sm.q[qr + 8][ks * 16 + 2 * t]);
        qf[ks][2] = ld_shared_u32(&sm.q[qr][ks * 16 + 8 + 2 * t]);
        qf[ks][3] = ld_shared_u32(&sm.q[qr + 8][ks * 16 + 8 + 2 * t]);
      }
    }

    // S = Qs K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kHeadDim / 16; ++ks) {
        const bf16* kr = &sm.k[buf][nt * 8 + g][ks * 16 + 2 * t];
        mma_16816(s[nt], qf[ks], ld_shared_u32(kr), ld_shared_u32(kr + 8));
      }
    }

    // Ragged tail: key columns at or beyond n are masked out.
    if (static_cast<long long>(j + 1) * kBlockN > n) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = j * kBlockN + nt * 8 + 2 * t + (c & 1);
          if (col >= n) s[nt][c] = kNegInf;
        }
      }
    }

    // Online softmax over the tile, one row at a time.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f((m[r] - mx) * kLog2e);
      m[r] = mx;
      l[r] *= alpha;
#pragma unroll
      for (int nt = 0; nt < kHeadDim / 8; ++nt) {
        acc[nt][2 * r] *= alpha;
        acc[nt][2 * r + 1] *= alpha;
      }
      const float mx2 = mx * kLog2e;
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int c = 2 * r; c < 2 * r + 2; ++c) {
          const float p = exp2f(fmaf(s[nt][c], kLog2e, -mx2));
          s[nt][c] = p;
          l[r] += p;
        }
      }
    }

    // acc += P V, with P rounded to bf16 straight from the S registers.
#pragma unroll
    for (int ks = 0; ks < kBlockN / 16; ++ks) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * ks][0], s[2 * ks][1]),
          pack_bf16(s[2 * ks][2], s[2 * ks][3]),
          pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
          pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]),
      };
      const int key = ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int dp = 0; dp < kHeadDim / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &sm.v[buf][key][dp * 16 + (lane >> 4) * 8]);
        mma_16816(acc[2 * dp], a, b[0], b[1]);
        mma_16816(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next iteration refills the other buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  bf16* ob = o + batch * o_sb + head * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = row0 + warp * 16 + g + 8 * r;
    if (row >= n) continue;
    const float inv_l = 1.f / l[r];
#pragma unroll
    for (int nt = 0; nt < kHeadDim / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(ob + row * o_sn + nt * 8 + 2 * t) =
          pack_bf16(acc[nt][2 * r] * inv_l, acc[nt][2 * r + 1] * inv_l);
    }
    if (t == 0) lse[(static_cast<long long>(batch) * heads + head) * n + row] = m[r] + logf(l[r]);
  }
}

}  // namespace

extern "C" int bvc_flash_fwd_d64(const void* q, const void* k, const void* v, void* o,
                                 void* lse, long long batch, long long n, long long heads,
                                 long long q_sb, long long q_sn, long long q_sh,
                                 long long k_sb, long long k_sn, long long k_sh,
                                 long long v_sb, long long v_sn, long long v_sh,
                                 long long o_sb, long long o_sn, long long o_sh,
                                 void* stream) {
  const dim3 grid(static_cast<unsigned>((n + kBlockM - 1) / kBlockM),
                  static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  flash_fwd_d64_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), static_cast<int>(n),
      static_cast<int>(heads), q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
      o_sb, o_sn, o_sh);
  return static_cast<int>(cudaGetLastError());
}
