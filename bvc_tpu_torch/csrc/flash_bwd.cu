// Backward flash attention with a per-sample key bias for Hopper (sm_90a),
// head widths 64 and 32: bf16 pre-scaled queries Qs, keys K, values V and
// output gradient dO, with the forward's f32 log-sum-exp L, D = rowsum(dO *
// O) in f32 (computed by the caller, as _bwd does) and a [B, N] f32 key
// bias.  Two kernels, no atomics, deterministic:
//
//   flash_bwd_dq_kernel  replaces bvc_tpu/ops/flash_attention.py::_dq_kernel_bias
//       dQs_i = sum_j dS_ij K_j
//   flash_bwd_dkv_kernel replaces bvc_tpu/ops/flash_attention.py::_dkv_kernel_bias
//       dV_j = sum_i P_ij^T dO_i,   dK_j = sum_i dS_ij^T Qs_i
//
// with P = exp(Qs K^T + bias - L) and dS = P * (dO V^T - D).  The same
// arithmetic as the TPU kernels: f32 scores, P rounded to bf16 before the dV
// product, dS rounded to bf16 before the dQ and dK products, f32 sums, bf16
// outputs.  No scale appears: Qs carries it, and autograd takes it through
// qs = q * scale into dQ (dK gets none).  Key columns at or beyond N get
// -inf.  A masked key's P is exp(-1e30 - L) = 0, so its dK and dV rows are
// exactly 0; a row with no attendable key has L = +inf (flash_fwd.cu), so
// its P is 0 too.  The bias gets no gradient (the TPU's _flash_b_bwd_rule
// returns zeros for it).  The unmasked backward is flash_bwd_sm90.cu.
//
// Bound.  Per (batch, head) the dQ kernel does three N x N x d products
// (6 N^2 d operations) and the dK/dV kernel four (8 N^2 d), against some
// 5 and 6 N d bf16 tensors of traffic.  At 160-200 tokens (JEPA's context
// encoder and predictor) the products are small and the kernels are bound
// by bytes.
//
// Design.  Blocks run in parallel on Hopper, so the TPU's sequential grid
// (which keeps all of K/V in VMEM) becomes a loop inside each CTA over
// 64-row tiles, double-buffered with cp.async.
// - dQ: one CTA of 4 warps per (64-query tile, head, batch element).  Qs and
//   dO of its rows go to registers once; for each K/V tile and its 64 key
//   biases S = Qs K^T + bias, P = exp(S - L), dP = dO V^T, dS = P (dP - D),
//   dQ += dS K.  dS goes from the accumulator registers straight into the
//   A operand, as P does in the forward.
// - dK/dV: one CTA per (64-key tile, head, batch element).  K and V of its
//   rows go to registers once, and so do the biases of its keys, which are
//   fixed for the CTA; it walks the queries in 64-row tiles (Qs, dO, L, D)
//   and computes the TRANSPOSED scores S^T = K Qs^T and dP^T = V dO^T, so
//   P^T and dS^T sit in accumulator registers in the A-operand layout of
//   dV += P^T dO and dK += dS^T Qs: no transpose goes through shared memory.
//   Query rows at or beyond N add nothing: their Qs/dO rows are zero-filled,
//   their L and D loads are zero-filled instead of read past the end of
//   [B, h, N], and their P^T columns are set to 0.
// Each kernel's tiles (two resident, four double-buffered, 55 KB at
// D = 64) exceed the 48 KB static limit, so they live in dynamic shared
// memory, raised with cudaFuncSetAttribute.  flash_common.cuh holds the
// tiles and products, templated on the head width.
//
// The library has a plain C interface, loaded with ctypes (as flash_fwd.cu):
// pointers and the stream as void*, sizes and strides in elements as long
// long.  The head-width stride must be 1 and rows must start on 16 bytes.
// L and D are contiguous [B, h, N] f32, the bias contiguous [B, N] f32.
// Each entry point returns a CUDA error code, 0 on success.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
struct __align__(16) DqTiles {
  Tile<D> q;
  Tile<D> dout;
  Tile<D> k[2];
  Tile<D> v[2];
  float bias[2][kBlockN];
};  // D = 64: 6 * 64 * 72 * 2 + 512 = 55808 bytes

template <int D>
struct __align__(16) DkvTiles {
  Tile<D> k;
  Tile<D> v;
  Tile<D> q[2];
  Tile<D> dout[2];
  float lse[2][kBlockM];
  float delta[2][kBlockM];
};  // D = 64: 55296 + 1024 = 56320 bytes

struct Strides {
  long long b, n, h;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ bias, bf16* __restrict__ dq, int n, int heads,
                    Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqTiles<D>& sm = *reinterpret_cast<DqTiles<D>*>(smem_raw);

  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBlockM;

  const bf16* qb = q + batch * qs.b + head * qs.h;
  const bf16* kb = k + batch * ks.b + head * ks.h;
  const bf16* vb = v + batch * vs.b + head * vs.h;
  const bf16* dob = dout + batch * dos.b + head * dos.h;
  const float* bias_row = bias + static_cast<long long>(batch) * n;

  load_tile<D>(sm.q, qb, row0, n, qs.n);
  load_tile<D>(sm.dout, dob, row0, n, dos.n);
  load_tile<D>(sm.k[0], kb, 0, n, ks.n);
  load_tile<D>(sm.v[0], vb, 0, n, vs.n);
  load_bias(sm.bias[0], bias_row, 0, n);
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

  uint32_t qf[D / 16][4], df[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
  }

  const int num_tiles = (n + kBlockN - 1) / kBlockN;
  for (int j = 0; j < num_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < num_tiles) {
      const long long next = static_cast<long long>(j + 1) * kBlockN;
      load_tile<D>(sm.k[buf ^ 1], kb, next, n, ks.n);
      load_tile<D>(sm.v[buf ^ 1], vb, next, n, vs.n);
      load_bias(sm.bias[buf ^ 1], bias_row, next, n);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just requested has landed
    __syncthreads();

    if (j == 0) {
      load_a_frags<D>(qf, sm.q, warp, lane);
      load_a_frags<D>(df, sm.dout, warp, lane);
    }

    // P = exp(Qs K^T + bias - L), with key columns at or beyond n masked out.
    float s[kBlockN / 8][4];
    product_abt<D>(s, qf, sm.k[buf], lane);
    add_bias(s, sm.bias[buf], lane);
    fill_cols_from(s, static_cast<long long>(j) * kBlockN, n, lane, -INFINITY);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = exp2f(fmaf(s[nt][c], kLog2e, -lse2[c >> 1]));
    }

    // dS = P (dO V^T - D), in place of P.
    float dp[kBlockN / 8][4];
    product_abt<D>(dp, df, sm.v[buf], lane);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] *= dp[nt][c] - dlt[c >> 1];
    }

    // dQ += dS K, dS rounded to bf16 straight from the registers.
    product_pb<D>(acc, s, sm.k[buf], lane);
    __syncthreads();  // the next iteration refills the other buffer
  }

  store_rows<D>(dq + batch * dqs.b + head * dqs.h, dqs.n, row0, n, acc, warp, lane);
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ bias, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int n, int heads, Strides qs, Strides ks,
                     Strides vs, Strides dos, Strides dks, Strides dvs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvTiles<D>& sm = *reinterpret_cast<DkvTiles<D>*>(smem_raw);

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

  load_tile<D>(sm.k, kb, key0, n, ks.n);
  load_tile<D>(sm.v, vb, key0, n, vs.n);
  load_tile<D>(sm.q[0], qb, 0, n, qs.n);
  load_tile<D>(sm.dout[0], dob, 0, n, dos.n);
  load_stats(sm.lse[0], sm.delta[0], lb, db, 0, n);
  cp_async_commit();

  // The key biases of this thread's key rows g and g + 8 (rows of S^T);
  // keys at or beyond n are never stored.
  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long key = key0 + warp * 16 + (lane >> 2) + 8 * r;
    kbias[r] = key < n ? bias[static_cast<long long>(batch) * n + key] : 0.f;
  }

  uint32_t kf[D / 16][4], vf[D / 16][4];
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[nt][c] = dv_acc[nt][c] = 0.f;
  }

  const int num_tiles = (n + kBlockM - 1) / kBlockM;
  for (int i = 0; i < num_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < num_tiles) {
      const long long next = static_cast<long long>(i + 1) * kBlockM;
      load_tile<D>(sm.q[buf ^ 1], qb, next, n, qs.n);
      load_tile<D>(sm.dout[buf ^ 1], dob, next, n, dos.n);
      load_stats(sm.lse[buf ^ 1], sm.delta[buf ^ 1], lb, db, next, n);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (i == 0) {
      load_a_frags<D>(kf, sm.k, warp, lane);
      load_a_frags<D>(vf, sm.v, warp, lane);
    }

    // P^T = exp(K Qs^T + bias[key] - L[query]): rows are this warp's 16
    // keys, columns the tile's 64 queries; query columns at or beyond n
    // are set to 0.
    float s[kBlockM / 8][4];
    product_abt<D>(s, kf, sm.q[buf], lane);
#pragma unroll
    for (int nt = 0; nt < kBlockM / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[nt][c] += kbias[c >> 1];
        const float l2 = sm.lse[buf][nt * 8 + 2 * t + (c & 1)] * kLog2e;
        s[nt][c] = exp2f(fmaf(s[nt][c], kLog2e, -l2));
      }
    }
    fill_cols_from(s, static_cast<long long>(i) * kBlockM, n, lane, 0.f);

    // dV += P^T dO, P^T rounded to bf16 straight from the registers.
    product_pb<D>(dv_acc, s, sm.dout[buf], lane);

    // dS^T = P^T (V dO^T - D[query]), in place of P^T; then dK += dS^T Qs.
    float dp[kBlockM / 8][4];
    product_abt<D>(dp, vf, sm.dout[buf], lane);
#pragma unroll
    for (int nt = 0; nt < kBlockM / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[nt][c] *= dp[nt][c] - sm.delta[buf][nt * 8 + 2 * t + (c & 1)];
    }
    product_pb<D>(dk_acc, s, sm.q[buf], lane);
    __syncthreads();  // the next iteration refills the other buffer
  }

  store_rows<D>(dk + batch * dks.b + head * dks.h, dks.n, key0, n, dk_acc, warp, lane);
  store_rows<D>(dv + batch * dvs.b + head * dvs.h, dvs.n, key0, n, dv_acc, warp, lane);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_dq(const void* const (&p)[8], long long batch, long long n,
                      long long heads, const long long (&s)[15], cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(DqTiles<D>));
  const auto kernel = flash_bwd_dq_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((n + kBlockM - 1) / kBlockM),
                  static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(p[0]), static_cast<const bf16*>(p[1]),
      static_cast<const bf16*>(p[2]), static_cast<const bf16*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<const float*>(p[6]), static_cast<bf16*>(const_cast<void*>(p[7])),
      static_cast<int>(n), static_cast<int>(heads), Strides{s[0], s[1], s[2]},
      Strides{s[3], s[4], s[5]}, Strides{s[6], s[7], s[8]}, Strides{s[9], s[10], s[11]},
      Strides{s[12], s[13], s[14]});
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* const (&p)[9], long long batch, long long n,
                       long long heads, const long long (&s)[18], cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(DkvTiles<D>));
  const auto kernel = flash_bwd_dkv_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((n + kBlockN - 1) / kBlockN),
                  static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(p[0]), static_cast<const bf16*>(p[1]),
      static_cast<const bf16*>(p[2]), static_cast<const bf16*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<const float*>(p[6]), static_cast<bf16*>(const_cast<void*>(p[7])),
      static_cast<bf16*>(const_cast<void*>(p[8])), static_cast<int>(n),
      static_cast<int>(heads), Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]},
      Strides{s[6], s[7], s[8]}, Strides{s[9], s[10], s[11]}, Strides{s[12], s[13], s[14]},
      Strides{s[15], s[16], s[17]});
  return cudaGetLastError();
}

}  // namespace

// The key-bias kernels at head_dim 64 or 32.  A null bias or any other
// width is refused with cudaErrorInvalidValue before anything launches.
extern "C" int bvc_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                const void* bias, void* dq, long long batch, long long n,
                                long long heads, long long head_dim,
                                long long q_sb, long long q_sn, long long q_sh,
                                long long k_sb, long long k_sn, long long k_sh,
                                long long v_sb, long long v_sn, long long v_sh,
                                long long do_sb, long long do_sn, long long do_sh,
                                long long dq_sb, long long dq_sn, long long dq_sh,
                                void* stream) {
  const void* const p[8] = {q, k, v, dout, lse, delta, bias, dq};
  const long long s[15] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn,
                           v_sh, do_sb, do_sn, do_sh, dq_sb, dq_sn, dq_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (bias != nullptr && head_dim == 64) {
    err = launch_dq<64>(p, batch, n, heads, s, st);
  } else if (bias != nullptr && head_dim == 32) {
    err = launch_dq<32>(p, batch, n, heads, s, st);
  }
  return static_cast<int>(err);
}

extern "C" int bvc_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 const void* bias, void* dk, void* dv, long long batch,
                                 long long n, long long heads, long long head_dim,
                                 long long q_sb, long long q_sn, long long q_sh,
                                 long long k_sb, long long k_sn, long long k_sh,
                                 long long v_sb, long long v_sn, long long v_sh,
                                 long long do_sb, long long do_sn, long long do_sh,
                                 long long dk_sb, long long dk_sn, long long dk_sh,
                                 long long dv_sb, long long dv_sn, long long dv_sh,
                                 void* stream) {
  const void* const p[9] = {q, k, v, dout, lse, delta, bias, dk, dv};
  const long long s[18] = {q_sb,  q_sn,  q_sh,  k_sb,  k_sn,  k_sh,  v_sb,  v_sn,  v_sh,
                           do_sb, do_sn, do_sh, dk_sb, dk_sn, dk_sh, dv_sb, dv_sn, dv_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (bias != nullptr && head_dim == 64) {
    err = launch_dkv<64>(p, batch, n, heads, s, st);
  } else if (bias != nullptr && head_dim == 32) {
    err = launch_dkv<32>(p, batch, n, heads, s, st);
  }
  return static_cast<int>(err);
}
