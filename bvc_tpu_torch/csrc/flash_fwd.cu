// Forward flash attention for Hopper (sm_90a): bf16 queries, keys and values,
// bf16 output and f32 log-sum-exp; without a key mask at head width 64, and
// with a per-sample key bias at head widths 64 and 32.
//
// Replaces bvc_tpu/ops/flash_attention.py::_fwd_kernel (no key mask) and
// ::_fwd_kernel_bias (key bias), both launched from _fwd.  Same arithmetic:
// non-causal attention over PRE-SCALED queries (the softmax scale is applied
// by the caller), online softmax with a running max m and a running sum l in
// f32, P rounded to bf16 before the P.V product, f32 accumulation,
// O = acc / l in bf16 and LSE = m + log(l) in f32.  Query rows at or beyond N
// are computed on zero-filled rows and never stored.  The TPU's lane padding
// of LSE to 8 is dropped: LSE is [B, h, N].
// - No key mask: key columns at or beyond N get -1e30, as _kmask does.  This
//   instantiation has no bias add, as _fwd_kernel_bias argues.
// - Key bias: S = Qs K^T + bias[b, key], the bias a [B, N] f32 row shared by
//   every head and query of a batch element (0 = attendable, -1e30 =
//   masked).  The TPU pads N to a multiple of 128 for lane-aligned bias
//   slices; here N is not padded, each key tile's 64 biases stream in with
//   its K/V tiles, and key columns at or beyond N get -inf, so that they
//   never tie with masked real keys.  P = exp2((S - m) log2 e): a row whose
//   every key is masked scores -1e30 on all of them, ties with m and gets
//   uniform weights over its N keys, as plain attention gives; its LSE is
//   stored as +inf, so the backward gives it P = 0 and no gradient.
//
// Bound.  At the extraction shape [B, 1568, 12, 64] the work per clip is
// 4*h*N^2*d = 7.55 GFLOP of tensor-core products (7.6 us at 989 TFLOP/s)
// against 9.6 MB of q/k/v/o traffic (2.9 us at 3.35 TB/s) and 29.5 M
// exponentials: bound by operations.  At JEPA's masked shapes (169 and 199
// tokens) the products per byte fall with N: bound by bytes.
//
// Design.  One CTA of 4 warps per (64-row query tile, head, batch element);
// each warp owns 16 query rows.  The CTA walks the keys in tiles of 64:
// K and V tiles (and the key-bias slice) are double-buffered in shared
// memory with cp.async, so the next tile streams in while the tensor cores
// work on the current one, and the N x N scores never leave registers.
// Both products run on mma.sync.m16n8k16 (bf16 in, f32 accumulate); the S
// accumulator's register layout is the A-operand layout of the P.V product,
// so P goes from registers to the tensor cores with no trip through shared
// memory (flash_common.cuh holds the tiles, copies and products shared with
// the backward kernels, templated on the head width).  wgmma, TMA and warp
// specialisation are left for later work.
//
// The library has a plain C interface, loaded with ctypes: pointers and the
// stream are passed as void*, sizes and strides (in elements) as long long;
// a null bias selects the unmasked kernel.  Each tensor is read through its
// strides; the innermost (head-width) stride must be 1 and every row must
// start on a 16-byte boundary, which the Python wrapper checks.  The bias is
// a contiguous [B, N] f32 row per batch element.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
struct __align__(16) FwdTiles {
  Tile<D> q;
  Tile<D> k[2];
  Tile<D> v[2];
};  // D = 64: 5 * 64 * 72 * 2 = 46080 bytes, under the 48 KB static limit

template <int D>
struct __align__(16) FwdBiasTiles : FwdTiles<D> {
  float bias[2][kBlockN];
};  // plus 512 bytes

template <int D, bool kKeyBias>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 bf16* __restrict__ o, float* __restrict__ lse, int n, int heads,
                 long long q_sb, long long q_sn, long long q_sh,
                 long long k_sb, long long k_sn, long long k_sh,
                 long long v_sb, long long v_sn, long long v_sh,
                 long long o_sb, long long o_sn, long long o_sh) {
  using Smem = std::conditional_t<kKeyBias, FwdBiasTiles<D>, FwdTiles<D>>;
  __shared__ Smem sm;

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
  const float* bias_row = kKeyBias ? bias + static_cast<long long>(batch) * n : nullptr;

  load_tile<D>(sm.q, qb, row0, n, q_sn);
  load_tile<D>(sm.k[0], kb, 0, n, k_sn);
  load_tile<D>(sm.v[0], vb, 0, n, v_sn);
  if constexpr (kKeyBias) load_bias(sm.bias[0], bias_row, 0, n);
  cp_async_commit();

  // This thread's rows of the warp's 16: r = 0 is row g, r = 1 is row g + 8.
  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
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
      load_tile<D>(sm.k[buf ^ 1], kb, next, n, k_sn);
      load_tile<D>(sm.v[buf ^ 1], vb, next, n, v_sn);
      if constexpr (kKeyBias) load_bias(sm.bias[buf ^ 1], bias_row, next, n);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just requested has landed
    __syncthreads();

    if (j == 0) load_a_frags<D>(qf, sm.q, warp, lane);

    // S = Qs K^T (+ bias) for this warp's 16 rows and the tile's 64 keys;
    // key columns at or beyond n are masked out.
    float s[kBlockN / 8][4];
    product_abt<D>(s, qf, sm.k[buf], lane);
    const long long col0 = static_cast<long long>(j) * kBlockN;
    if constexpr (kKeyBias) {
      add_bias(s, sm.bias[buf], lane);
      fill_cols_from(s, col0, n, lane, -INFINITY);
    } else {
      fill_cols_from(s, col0, n, lane, kNegInf);
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
      for (int nt = 0; nt < D / 8; ++nt) {
        acc[nt][2 * r] *= alpha;
        acc[nt][2 * r + 1] *= alpha;
      }
      const float mx2 = mx * kLog2e;
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int c = 2 * r; c < 2 * r + 2; ++c) {
          // with a key bias, a masked key that ties with m must give exactly
          // 1: subtract first (fmaf(s, log2e, -mx2) rounds mx2 apart from s)
          const float p = kKeyBias ? exp2f((s[nt][c] - mx) * kLog2e)
                                   : exp2f(fmaf(s[nt][c], kLog2e, -mx2));
          s[nt][c] = p;
          l[r] += p;
        }
      }
    }

    // acc += P V, with P rounded to bf16 straight from the S registers.
    product_pb<D>(acc, s, sm.v[buf], lane);
    __syncthreads();  // the next iteration refills the other buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv_l = 1.f / l[r];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][2 * r] *= inv_l;
      acc[nt][2 * r + 1] *= inv_l;
    }
    const long long row = row0 + warp * 16 + g + 8 * r;
    if (t == 0 && row < n) {
      // a row with no attendable key: +inf, so the backward's P is 0
      const bool no_key = kKeyBias && m[r] <= kNegInf;
      lse[(static_cast<long long>(batch) * heads + head) * n + row] =
          no_key ? INFINITY : m[r] + logf(l[r]);
    }
  }
  store_rows<D>(o + batch * o_sb + head * o_sh, o_sn, row0, n, acc, warp, lane);
}

template <int D, bool kKeyBias>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* o,
                   void* lse, long long batch, long long n, long long heads,
                   const long long (&s)[12], cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kBlockM - 1) / kBlockM),
                  static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  flash_fwd_kernel<D, kKeyBias><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(o), static_cast<float*>(lse),
      static_cast<int>(n), static_cast<int>(heads), s[0], s[1], s[2], s[3], s[4], s[5],
      s[6], s[7], s[8], s[9], s[10], s[11]);
  return cudaGetLastError();
}

}  // namespace

// bias == nullptr: the unmasked kernel (head_dim 64); otherwise the
// key-bias kernel (head_dim 64 or 32).  Any other width is refused with
// cudaErrorInvalidValue before anything launches.
extern "C" int bvc_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                             void* o, void* lse, long long batch, long long n,
                             long long heads, long long head_dim,
                             long long q_sb, long long q_sn, long long q_sh,
                             long long k_sb, long long k_sn, long long k_sh,
                             long long v_sb, long long v_sn, long long v_sh,
                             long long o_sb, long long o_sn, long long o_sh,
                             void* stream) {
  const long long s[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                           v_sb, v_sn, v_sh, o_sb, o_sn, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (bias == nullptr && head_dim == 64) {
    err = launch<64, false>(q, k, v, bias, o, lse, batch, n, heads, s, st);
  } else if (bias != nullptr && head_dim == 64) {
    err = launch<64, true>(q, k, v, bias, o, lse, batch, n, heads, s, st);
  } else if (bias != nullptr && head_dim == 32) {
    err = launch<32, true>(q, k, v, bias, o, lse, batch, n, heads, s, st);
  }
  return static_cast<int>(err);
}
