// The softmax-dtype probe's attention forward for Hopper (sm_90a): bf16
// pre-scaled queries, keys and values [B, h, N, 64], bf16 output, with the
// score arithmetic in f32 or in bf16.
//
// Replaces tools/probe_softmax_dtype.py::_fwd_kernel (launched from fwd
// there), which computes, per query block over the full K and V:
// - f32 scores: S = Qs K^T (f32), m = rowmax S, p = exp(S - m) (f32),
//   l = sum p, O = bf16((bf16(p) V, f32 sums) / l);
// - bf16 scores: every step rounds to bf16: s = bf16(Qs K^T), m = max s,
//   d = bf16(s - m), p = bf16(exp(d)), l = sum of p in f32,
//   O = bf16((p V, f32 sums) / l).
// This is not flash_fwd.cu's online softmax: there, rescaling the running
// sums would round differently in bf16.  The TPU kernel holds all N keys
// in VMEM; at N = 1568 one (batch, head)'s K and V take 401 KB, above the
// 227 KB of shared memory a CTA can have, so this kernel streams K and V in
// two passes over 64-key tiles: the row max first, then exp, sum and P V,
// which computes the same function.  Keys at or beyond N score -inf, so N
// need not divide into tiles (the TPU padded the JEPA target's 392 to 512).
// expf, not __expf or exp2 tricks, so that p agrees with torch.exp to ulps;
// O = acc / l by division, as the plain version divides.
//
// Bound.  The function takes 4 B h N^2 d tensor-core operations: 0.052 ms
// at [64, 12, 512, 64] and 0.183 ms at [48, 6, 1568, 64] at 989 TFLOP/s,
// above their q/k/v/o bytes at 3.35 TB/s; the two-pass design does 1.5x
// those operations (Qs K^T twice) to keep the function exact.
//
// Design.  One CTA of 4 warps per (64-query tile, head, batch element), as
// flash_fwd.cu, with its tiles, copies and products (flash_common.cuh):
// K tiles (pass 1) and K and V tiles (pass 2) double-buffered with
// cp.async, scores kept in registers, P fed from the score registers into
// the P V product.
//
// Plain C interface, loaded with ctypes: pointers and the stream as void*,
// sizes and strides (in elements, [B, h, N] order) as long long.  The
// innermost stride must be 1 and every row must start on 16 bytes, which
// the Python wrapper ensures.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kD = 64;  // the probe's head width

struct __align__(16) ProbeTiles {
  Tile<kD> q;
  Tile<kD> k[2];
  Tile<kD> v[2];
};  // 46,080 bytes, under the 48 KB static limit

struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// S = Qs K^T for this warp's 16 rows and one 64-key tile, rounded to bf16
// for bf16 scores; keys at or beyond n get -inf.
template <bool kBf16Scores>
__device__ __forceinline__ void scores(float (&s)[kBlockN / 8][4],
                                       const uint32_t (&qf)[kD / 16][4], const Tile<kD>& k,
                                       long long col0, int n, int lane) {
  product_abt<kD>(s, qf, k, lane);
  if constexpr (kBf16Scores) {
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = round_bf16(s[nt][c]);
    }
  }
  fill_cols_from(s, col0, n, lane, -INFINITY);
}

template <bool kBf16Scores>
__global__ void __launch_bounds__(kThreads)
softmax_probe_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int n, Strides qs,
                     Strides ks, Strides vs, Strides os) {
  __shared__ ProbeTiles sm;

  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBlockM;
  const bf16* qb = q + batch * qs.b + head * qs.h;
  const bf16* kb = k + batch * ks.b + head * ks.h;
  const bf16* vb = v + batch * vs.b + head * vs.h;
  const int num_tiles = (n + kBlockN - 1) / kBlockN;

  // Pass 1: the row max of the scores.  This thread's rows of the warp's
  // 16: r = 0 is row g, r = 1 is row g + 8.
  load_tile<kD>(sm.q, qb, row0, n, qs.n);
  load_tile<kD>(sm.k[0], kb, 0, n, ks.n);
  cp_async_commit();
  uint32_t qf[kD / 16][4];
  float m[2] = {-INFINITY, -INFINITY};
  for (int j = 0; j < num_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < num_tiles) load_tile<kD>(sm.k[buf ^ 1], kb, (j + 1) * kBlockN, n, ks.n);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) load_a_frags<kD>(qf, sm.q, warp, lane);
    float s[kBlockN / 8][4];
    scores<kBf16Scores>(s, qf, sm.k[buf], static_cast<long long>(j) * kBlockN, n, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt)
        m[r] = fmaxf(m[r], fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
    }
    __syncthreads();  // the next iteration refills the other buffer
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }

  // Pass 2: p = exp(s - m), l = sum p, acc = P V.
  load_tile<kD>(sm.k[0], kb, 0, n, ks.n);
  load_tile<kD>(sm.v[0], vb, 0, n, vs.n);
  cp_async_commit();
  float acc[kD / 8][4];
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
  }
  for (int j = 0; j < num_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < num_tiles) {
      load_tile<kD>(sm.k[buf ^ 1], kb, (j + 1) * kBlockN, n, ks.n);
      load_tile<kD>(sm.v[buf ^ 1], vb, (j + 1) * kBlockN, n, vs.n);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[kBlockN / 8][4];
    scores<kBf16Scores>(s, qf, sm.k[buf], static_cast<long long>(j) * kBlockN, n, lane);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float mr = m[c >> 1];
        const float p = kBf16Scores ? round_bf16(expf(round_bf16(s[nt][c] - mr)))
                                    : expf(s[nt][c] - mr);
        s[nt][c] = p;
        l[c >> 1] += p;
      }
    }
    // acc += P V, P rounded to bf16 (exact for bf16 scores) on the way.
    product_pb<kD>(acc, s, sm.v[buf], lane);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      acc[nt][2 * r] = __fdiv_rn(acc[nt][2 * r], l[r]);
      acc[nt][2 * r + 1] = __fdiv_rn(acc[nt][2 * r + 1], l[r]);
    }
  }
  store_rows<kD>(o + batch * os.b + head * os.h, os.n, row0, n, acc, warp, lane);
}

template <bool kBf16Scores>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, long long batch,
                   long long heads, long long n, const long long (&s)[12],
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kBlockM - 1) / kBlockM),
                  static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  softmax_probe_kernel<kBf16Scores><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<int>(n), Strides{s[0], s[1], s[2]},
      Strides{s[3], s[4], s[5]}, Strides{s[6], s[7], s[8]}, Strides{s[9], s[10], s[11]});
  return cudaGetLastError();
}

}  // namespace

// bf16_scores 0: f32 score arithmetic; 1: bf16.  Strides are (batch, head,
// token) of each [B, h, N, 64] tensor.  Any head width but 64 is refused
// with cudaErrorInvalidValue before anything launches.
extern "C" int bvc_softmax_probe_fwd(const void* q, const void* k, const void* v, void* o,
                                     long long batch, long long heads, long long n,
                                     long long head_dim, long long bf16_scores,
                                     long long q_sb, long long q_sh, long long q_sn,
                                     long long k_sb, long long k_sh, long long k_sn,
                                     long long v_sb, long long v_sh, long long v_sn,
                                     long long o_sb, long long o_sh, long long o_sn,
                                     void* stream) {
  const long long s[12] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                           v_sb, v_sh, v_sn, o_sb, o_sh, o_sn};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim != kD) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = bf16_scores ? launch<true>(q, k, v, o, batch, heads, n, s, st)
                                      : launch<false>(q, k, v, o, batch, heads, n, s, st);
  return static_cast<int>(err);
}
