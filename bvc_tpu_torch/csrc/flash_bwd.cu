// Backward flash attention for Hopper (sm_90a): bf16 pre-scaled queries Qs,
// keys K, values V and output gradient dO of head width 64, with the
// forward's f32 log-sum-exp L and D = rowsum(dO * O) in f32 (computed by the
// caller, as _bwd does).  Two kernels, no atomics, deterministic:
//
//   flash_bwd_dq_d64_kernel  replaces bvc_tpu/ops/flash_attention.py::_dq_kernel
//       dQs_i = sum_j dS_ij K_j
//   flash_bwd_dkv_d64_kernel replaces bvc_tpu/ops/flash_attention.py::_dkv_kernel
//       dV_j = sum_i P_ij^T dO_i,   dK_j = sum_i dS_ij^T Qs_i
//
// with P = exp(Qs K^T - L) and dS = P * (dO V^T - D).  The same arithmetic
// as the TPU kernels: f32 scores, P rounded to bf16 before the dV product,
// dS rounded to bf16 before the dQ and dK products, f32 sums, bf16 outputs.
// No scale appears: Qs carries it, and autograd takes it through
// qs = q * scale into dQ (dK gets none).  Key columns at or beyond N get
// -1e30 before the exp, as _kmask does.
//
// Bound.  Per (batch, head) the dQ kernel does three N x N x 64 products
// (6 N^2 d operations) and the dK/dV kernel four (8 N^2 d), against some
// 5 and 6 N d bf16 tensors of traffic.  At the decoder shape
// [B, 1568, 6, 64] that is 5.7 and 7.6 GFLOP per clip (5.7 and 7.6 us at
// 989 TFLOP/s) against about 6 MB of bytes (1.8 us at 3.35 TB/s): bound by
// operations.  At the encoder's 160 visible tokens the products shrink
// with N^2 and the kernels are bound by bytes.
//
// Design.  Blocks run in parallel on Hopper, so the TPU's sequential grid
// (which keeps all of K/V in VMEM, 784-row blocks) becomes a loop inside
// each CTA over 64-row tiles, double-buffered with cp.async.
// - dQ: one CTA of 4 warps per (64-query tile, head, batch element).  Qs and
//   dO of its rows go to registers once; for each K/V tile S = Qs K^T,
//   P = exp(S - L), dP = dO V^T, dS = P (dP - D), dQ += dS K.  The
//   flash_fwd.cu structure plus one product; dS goes from the accumulator
//   registers straight into the A operand, as P does in the forward.
// - dK/dV: one CTA per (64-key tile, head, batch element).  K and V of its
//   rows go to registers once; it walks the queries in 64-row tiles (Qs,
//   dO, L, D) and computes the TRANSPOSED scores S^T = K Qs^T and
//   dP^T = V dO^T, so P^T and dS^T sit in accumulator registers in the
//   A-operand layout of dV += P^T dO and dK += dS^T Qs: no transpose goes
//   through shared memory.  Query rows at or beyond N add nothing: their
//   Qs/dO rows are zero-filled, their L and D loads are zero-filled instead
//   of read past the end of [B, h, N], and their P^T columns are set to 0.
// Each kernel's tiles (two resident, four double-buffered, 55 KB) exceed the
// 48 KB static limit, so they live in dynamic shared memory, raised with
// cudaFuncSetAttribute.  wgmma, TMA and a fused dQ with atomics are left for
// later work.
//
// The library has a plain C interface, loaded with ctypes (as flash_fwd.cu):
// pointers and the stream as void*, strides in elements as long long; the
// head-width stride must be 1 and rows must start on 16 bytes.  L and D are
// contiguous [B, h, N] f32.  Each entry point returns cudaGetLastError().

#include "flash_common.cuh"

namespace {

using namespace flash;

struct __align__(16) DqTiles {
  Tile q;
  Tile dout;
  Tile k[2];
  Tile v[2];
};  // 6 * 64 * 72 * 2 = 55296 bytes

struct __align__(16) DkvTiles {
  Tile k;
  Tile v;
  Tile q[2];
  Tile dout[2];
  float lse[2][kBlockM];
  float delta[2][kBlockM];
};  // 55296 + 1024 = 56320 bytes

struct Strides {
  long long b, n, h;
};

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_d64_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int n, int heads, Strides qs, Strides ks,
                        Strides vs, Strides dos, Strides dqs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqTiles& sm = *reinterpret_cast<DqTiles*>(smem_raw);

  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBlockM;

  const bf16* qb = q + batch * qs.b + head * qs.h;
  const bf16* kb = k + batch * ks.b + head * ks.h;
  const bf16* vb = v + batch * vs.b + head * vs.h;
  const bf16* dob = dout + batch * dos.b + head * dos.h;

  load_tile(sm.q, qb, row0, n, qs.n);
  load_tile(sm.dout, dob, row0, n, dos.n);
  load_tile(sm.k[0], kb, 0, n, ks.n);
  load_tile(sm.v[0], vb, 0, n, vs.n);
  cp_async_commit();

  // L (times log2 e) and D of this thread's rows g and g + 8; rows at or
  // beyond n are never stored, and get finite stand-ins.
  const long long stat0 = (static_cast<long long>(batch) * heads + head) * n;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = row0 + warp * 16 + (lane >> 2) + 8 * r;
    const bool valid = row < n;
    lse2[r] = valid ? lse[stat0 + row] * kLog2e : 0.f;
    dlt[r] = valid ? delta[stat0 + row] : 0.f;
  }

  uint32_t qf[kHeadDim / 16][4], df[kHeadDim / 16][4];
  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
  }

  const int num_tiles = (n + kBlockN - 1) / kBlockN;
  for (int j = 0; j < num_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < num_tiles) {
      load_tile(sm.k[buf ^ 1], kb, static_cast<long long>(j + 1) * kBlockN, n, ks.n);
      load_tile(sm.v[buf ^ 1], vb, static_cast<long long>(j + 1) * kBlockN, n, vs.n);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just requested has landed
    __syncthreads();

    if (j == 0) {
      load_a_frags(qf, sm.q, warp, lane);
      load_a_frags(df, sm.dout, warp, lane);
    }

    // P = exp(Qs K^T - L), with key columns at or beyond n masked out.
    float s[kBlockN / 8][4];
    product_abt(s, qf, sm.k[buf], lane);
    fill_cols_from(s, static_cast<long long>(j) * kBlockN, n, lane, kNegInf);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = exp2f(fmaf(s[nt][c], kLog2e, -lse2[c >> 1]));
    }

    // dS = P (dO V^T - D), in place of P.
    float dp[kBlockN / 8][4];
    product_abt(dp, df, sm.v[buf], lane);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] *= dp[nt][c] - dlt[c >> 1];
    }

    // dQ += dS K, dS rounded to bf16 straight from the registers.
    product_pb(acc, s, sm.k[buf], lane);
    __syncthreads();  // the next iteration refills the other buffer
  }

  store_rows(dq + batch * dqs.b + head * dqs.h, dqs.n, row0, n, acc, warp, lane);
}

// Rows [row0, row0 + 64) of L and D into shared memory, one f32 per thread;
// rows at or beyond n are zero-filled, never read.
__device__ __forceinline__ void load_stats(float (&l_dst)[kBlockM], float (&d_dst)[kBlockM],
                                           const float* l_src, const float* d_src,
                                           long long row0, int n) {
  static_assert(kThreads == 2 * kBlockM, "one thread per L or D entry");
  const int i = threadIdx.x & (kBlockM - 1);
  const long long row = row0 + i;
  const bool valid = row < n;
  const long long at = valid ? row : 0;
  if (threadIdx.x < kBlockM) {
    cp_async_4(&l_dst[i], l_src + at, valid);
  } else {
    cp_async_4(&d_dst[i], d_src + at, valid);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_d64_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int heads,
                         Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
                         Strides dvs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvTiles& sm = *reinterpret_cast<DkvTiles*>(smem_raw);

  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const long long key0 = static_cast<long long>(blockIdx.x) * kBlockN;

  const bf16* qb = q + batch * qs.b + head * qs.h;
  const bf16* kb = k + batch * ks.b + head * ks.h;
  const bf16* vb = v + batch * vs.b + head * vs.h;
  const bf16* dob = dout + batch * dos.b + head * dos.h;
  const long long stat0 = (static_cast<long long>(batch) * heads + head) * n;
  const float* lb = lse + stat0;
  const float* db = delta + stat0;

  load_tile(sm.k, kb, key0, n, ks.n);
  load_tile(sm.v, vb, key0, n, vs.n);
  load_tile(sm.q[0], qb, 0, n, qs.n);
  load_tile(sm.dout[0], dob, 0, n, dos.n);
  load_stats(sm.lse[0], sm.delta[0], lb, db, 0, n);
  cp_async_commit();

  uint32_t kf[kHeadDim / 16][4], vf[kHeadDim / 16][4];
  float dk_acc[kHeadDim / 8][4], dv_acc[kHeadDim / 8][4];
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[nt][c] = dv_acc[nt][c] = 0.f;
  }

  const int num_tiles = (n + kBlockM - 1) / kBlockM;
  for (int i = 0; i < num_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < num_tiles) {
      const long long next = static_cast<long long>(i + 1) * kBlockM;
      load_tile(sm.q[buf ^ 1], qb, next, n, qs.n);
      load_tile(sm.dout[buf ^ 1], dob, next, n, dos.n);
      load_stats(sm.lse[buf ^ 1], sm.delta[buf ^ 1], lb, db, next, n);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (i == 0) {
      load_a_frags(kf, sm.k, warp, lane);
      load_a_frags(vf, sm.v, warp, lane);
    }

    // P^T = exp(K Qs^T - L[query]): rows are this warp's 16 keys, columns
    // the tile's 64 queries; query columns at or beyond n are set to 0.
    float s[kBlockM / 8][4];
    product_abt(s, kf, sm.q[buf], lane);
#pragma unroll
    for (int nt = 0; nt < kBlockM / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float l2 = sm.lse[buf][nt * 8 + 2 * t + (c & 1)] * kLog2e;
        s[nt][c] = exp2f(fmaf(s[nt][c], kLog2e, -l2));
      }
    }
    fill_cols_from(s, static_cast<long long>(i) * kBlockM, n, lane, 0.f);

    // dV += P^T dO, P^T rounded to bf16 straight from the registers.
    product_pb(dv_acc, s, sm.dout[buf], lane);

    // dS^T = P^T (V dO^T - D[query]), in place of P^T; then dK += dS^T Qs.
    float dp[kBlockM / 8][4];
    product_abt(dp, vf, sm.dout[buf], lane);
#pragma unroll
    for (int nt = 0; nt < kBlockM / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[nt][c] *= dp[nt][c] - sm.delta[buf][nt * 8 + 2 * t + (c & 1)];
    }
    product_pb(dk_acc, s, sm.q[buf], lane);
    __syncthreads();  // the next iteration refills the other buffer
  }

  store_rows(dk + batch * dks.b + head * dks.h, dks.n, key0, n, dk_acc, warp, lane);
  store_rows(dv + batch * dvs.b + head * dvs.h, dvs.n, key0, n, dv_acc, warp, lane);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" int bvc_flash_bwd_dq_d64(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, long long batch, long long n, long long heads,
                                    long long q_sb, long long q_sn, long long q_sh,
                                    long long k_sb, long long k_sn, long long k_sh,
                                    long long v_sb, long long v_sn, long long v_sh,
                                    long long do_sb, long long do_sn, long long do_sh,
                                    long long dq_sb, long long dq_sn, long long dq_sh,
                                    void* stream) {
  const int smem = static_cast<int>(sizeof(DqTiles));
  cudaError_t err = allow_smem(flash_bwd_dq_d64_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + kBlockM - 1) / kBlockM),
                  static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  flash_bwd_dq_d64_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), static_cast<int>(n),
      static_cast<int>(heads), Strides{q_sb, q_sn, q_sh}, Strides{k_sb, k_sn, k_sh},
      Strides{v_sb, v_sn, v_sh}, Strides{do_sb, do_sn, do_sh}, Strides{dq_sb, dq_sn, dq_sh});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvc_flash_bwd_dkv_d64(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, long long batch, long long n,
                                     long long heads,
                                     long long q_sb, long long q_sn, long long q_sh,
                                     long long k_sb, long long k_sn, long long k_sh,
                                     long long v_sb, long long v_sn, long long v_sh,
                                     long long do_sb, long long do_sn, long long do_sh,
                                     long long dk_sb, long long dk_sn, long long dk_sh,
                                     long long dv_sb, long long dv_sn, long long dv_sh,
                                     void* stream) {
  const int smem = static_cast<int>(sizeof(DkvTiles));
  cudaError_t err = allow_smem(flash_bwd_dkv_d64_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + kBlockN - 1) / kBlockN),
                  static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  flash_bwd_dkv_d64_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<int>(n), static_cast<int>(heads), Strides{q_sb, q_sn, q_sh},
      Strides{k_sb, k_sn, k_sh}, Strides{v_sb, v_sn, v_sh}, Strides{do_sb, do_sn, do_sh},
      Strides{dk_sb, dk_sn, dk_sh}, Strides{dv_sb, dv_sn, dv_sh});
  return static_cast<int>(cudaGetLastError());
}
