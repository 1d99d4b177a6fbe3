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
// - No key mask: key columns at or beyond N get -1e30, as _kmask does, and
//   p = exp2(s log2 e - m log2 e) by one fmaf.
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
// exponentials, 7.0 us at 16 a clock on each of 132 SMs at 1.98 GHz: the
// exponentials weigh almost as much as the products, so the kernel reaches
// its bound only if one warpgroup's exponentials run beside another's
// products.  At JEPA's masked shapes (169 and 199 tokens) the products per
// byte fall with N: bound by bytes.
//
// Design, unmasked (d = 64): the warp-specialised Hopper mainloop of
// attn_sm90.cuh, persistent CTAs of four warpgroups walking tiles of 192
// queries of a (head, batch element): a TMA producer, three consumer
// warpgroups on wgmma taking turns at the tensor cores (at d = 64 each K
// and V tile does little work, so a taller query tile pulls less of them
// from L2 a query; 160 registers a consumer thread), the softmax of one
// key tile overlapping the P V product of the one before, and the rescale
// of O to a new running max overlapping the next S product.  exp2 is the
// SFU's ex2.approx.ftz (exp2f's own instruction without its subnormal
// fixup), so one instruction a score sits on the 16-a-clock pipe.
//
// Design, key bias (d = 64 and 32): one CTA of 4 warps per (64-row query
// tile, head, batch element); each warp owns 16 query rows.  The CTA walks
// the keys in tiles of 64: K and V tiles and the key-bias slice are
// double-buffered in shared memory with cp.async, the scores never leave
// registers, and both products run on mma.sync.m16n8k16 (flash_common.cuh
// holds the tiles, copies and products shared with the backward kernels,
// templated on the head width).
//
// The library has a plain C interface, loaded with ctypes: pointers and the
// stream are passed as void*, sizes and strides (in elements) as long long;
// a null bias selects the unmasked kernel.  Each tensor is read through its
// strides; the innermost (head-width) stride must be 1 and every row must
// start on a 16-byte boundary, which the Python wrapper checks.  The bias is
// a contiguous [B, N] f32 row per batch element.  bvc_attn_tile_check runs
// the unmasked kernel's products on one tile, for a first check on a new
// card or toolkit.

#include "attn_sm90.cuh"
#include "flash_common.cuh"

namespace {

// ---- unmasked, d = 64: Hopper -------------------------------------------

// Three consumer warpgroups: 192-query tiles pull 1.5x less K and V from L2
// a query than 128-query ones.
using FwdCta = attn::Cta<3>;

__global__ void __launch_bounds__(FwdCta::kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_o,
               float* __restrict__ lse, int n, int heads, int batches) {
  using namespace attn;
  using C = FwdCta;
  extern __shared__ unsigned char smem_raw[];
  C::Smem& sm = C::smem_of(smem_raw);
  const int n_tiles = (n + kBlockN - 1) / kBlockN;  // key tiles
  const C::Work work = C::work(n, heads, batches);
  // warp-uniform by construction, so that ptxas sees each role's wgmma on a
  // path no warp diverges into
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) C::init_barriers(sm);
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<C::kProducerRegs>();
    if (threadIdx.x == 0) C::produce(sm, &map_q, &map_k, &map_v, work, n_tiles, 1);
    return;
  }
  hopper::setmaxnreg_inc<C::kConsumerRegs>();
  const int c = wg - 1;
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const uint32_t q_addr = hopper::smem_addr(sm.q) + c * kHalfBytes;

  float s[64], o[32];
  uint32_t p[32];
  float m[2], l[2], alpha[2];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;

  // The softmax of a scored tile, in place: the new running max, the
  // rescale alpha of what came before, p = exp2(s log2 e - m log2 e), l.
  auto softmax = [&]() {
    float mx[2] = {m[0], m[1]};
    thread_max(s, mx);
    quad_max(mx);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = ex2((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
    }
    const float mx2[2] = {mx[0] * kLog2e, mx[1] * kLog2e};
    float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // two chains a row half
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      s[i] = ex2(fmaf(s[i], kLog2e, -mx2[half_of(i)]));
      sum[half_of(i)][i & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + (sum[r][0] + sum[r][1]);
  };

  auto rescale = [](float (&acc)[32], const float (&a)[2]) {
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] *= a[half_of(j)];
  };

  Ring kr, vr;
  uint32_t q_phase = 0;
  C::turn_pass_if(c, c == C::kLast);
  for (int w = blockIdx.x; w < work.tiles; w += gridDim.x) {
    const bool last = w + static_cast<int>(gridDim.x) >= work.tiles;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    hopper::fence_operands(o);
    hopper::mbar_wait(&sm.q_full, q_phase);
    q_phase ^= 1;

    // The last key tile, the only ragged one, with nothing else in flight.
    hopper::mbar_wait(&sm.k_full[kr.stage], kr.phase);
    C::turn_wait(c);
    hopper::wgmma_fence();
    issue_s(s, q_addr, hopper::smem_addr(sm.k[kr.stage]));
    hopper::wgmma_commit();
    C::turn_pass_if(c, true);
    hopper::wgmma_wait<0>();
    hopper::fence_operands(s);
    hopper::mbar_arrive_if(&sm.k_empty[kr.stage], lane == 0);
    kr.advance();
    mask_cols(s, n - (n_tiles - 1) * kBlockN, t, kNegInf);
    softmax();
    pack_p(p, s);

    for (int i = 1; i < n_tiles; ++i) {
      hopper::mbar_wait(&sm.k_full[kr.stage], kr.phase);
      hopper::mbar_wait(&sm.v_full[vr.stage], vr.phase);
      C::turn_wait(c);
      hopper::wgmma_fence();
      issue_s(s, q_addr, hopper::smem_addr(sm.k[kr.stage]));
      hopper::wgmma_commit();
      rescale(o, alpha);  // to the max of the tile before, while S runs
      hopper::wgmma_fence();
      issue_pv(o, p, hopper::smem_addr(sm.v[vr.stage]));
      hopper::wgmma_commit();
      C::turn_pass_if(c, true);
      hopper::wgmma_wait<1>();  // S has landed; P V of the tile before runs on
      hopper::fence_operands(s);
      hopper::mbar_arrive_if(&sm.k_empty[kr.stage], lane == 0);
      kr.advance();
      softmax();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(o);
      hopper::fence_operands(p);
      hopper::mbar_arrive_if(&sm.v_empty[vr.stage], lane == 0);
      vr.advance();
      pack_p(p, s);
    }
    // every product that reads Q has landed: the producer may load the next
    hopper::mbar_arrive_if(&sm.q_empty, lane == 0);

    // P V of the first key tile.
    hopper::mbar_wait(&sm.v_full[vr.stage], vr.phase);
    C::turn_wait(c);
    rescale(o, alpha);
    hopper::wgmma_fence();
    issue_pv(o, p, hopper::smem_addr(sm.v[vr.stage]));
    hopper::wgmma_commit();
    C::turn_pass_if(c, c != C::kLast || !last);
    hopper::wgmma_wait<0>();
    hopper::fence_operands(o);
    hopper::fence_operands(p);
    hopper::mbar_arrive_if(&sm.v_empty[vr.stage], lane == 0);
    vr.advance();

    row_sum(l);
    const int row0 = work.row0(w);
    const int head = work.head(w);
    const int batch = work.batch(w);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv_l = 1.f / l[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j + 2 * r] *= inv_l;
        o[4 * j + 2 * r + 1] *= inv_l;
      }
      const int row = row0 + 64 * c + 16 * warp + (lane >> 2) + 8 * r;
      if (t == 0 && row < n) {
        lse[(static_cast<long long>(batch) * heads + head) * n + row] = m[r] + logf(l[r]);
      }
    }
    C::store_o(sm.o[c], o, &map_o, row0 + 64 * c, head, batch, c, warp, lane);
  }
  hopper::bulk_wait_all();  // the stores read shared memory that lives as long as the CTA
}

// One warpgroup: S [64 x 128] = Q K^T from TMA-loaded tiles on wgmma, then
// O [64 x 64] = bf16(S) V with P from registers and V transposed, both
// written as f32 rows.
__global__ void __launch_bounds__(128, 1)
attn_tile_check_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, float* __restrict__ s_out,
                       float* __restrict__ o_out) {
  using namespace attn;
  extern __shared__ unsigned char smem_raw[];
  FwdCta::Smem& sm = FwdCta::smem_of(smem_raw);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.q_full, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(&sm.q_full, kHalfBytes + 2 * kTileBytes);
    hopper::tma_load_4d(sm.q, &map_q, 0, 0, 0, 0, &sm.q_full);
    hopper::tma_load_4d(sm.k[0], &map_k, 0, 0, 0, 0, &sm.q_full);
    hopper::tma_load_4d(sm.v[0], &map_v, 0, 0, 0, 0, &sm.q_full);
  }
  hopper::mbar_wait(&sm.q_full, 0);

  float s[64], o[32];
  uint32_t p[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  hopper::wgmma_fence();
  issue_s(s, hopper::smem_addr(sm.q), hopper::smem_addr(sm.k[0]));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_operands(s);
  const int row = 16 * warp + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 64; ++i) s_out[(row + 8 * half_of(i)) * kBlockN + col_of(i, t)] = s[i];

  pack_p(p, s);
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  hopper::fence_operands(o);
  hopper::wgmma_fence();
  issue_pv(o, p, hopper::smem_addr(sm.v[0]));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_operands(o);
  hopper::fence_operands(p);
#pragma unroll
  for (int i = 0; i < 32; ++i) o_out[(row + 8 * half_of(i)) * kD + col_of(i, t)] = o[i];
}

// ---- key bias, d = 64 and 32: mma.sync ----------------------------------

using namespace flash;

template <int D>
struct __align__(16) FwdBiasTiles {
  Tile<D> q;
  Tile<D> k[2];
  Tile<D> v[2];
  float bias[2][kBlockN];
};  // D = 64: 5 * 64 * 72 * 2 + 512 = 46592 bytes, under the 48 KB static limit

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bias_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ bias,
                      bf16* __restrict__ o, float* __restrict__ lse, int n, int heads,
                      long long q_sb, long long q_sn, long long q_sh,
                      long long k_sb, long long k_sn, long long k_sh,
                      long long v_sb, long long v_sn, long long v_sh,
                      long long o_sb, long long o_sn, long long o_sh) {
  __shared__ FwdBiasTiles<D> sm;

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
  const float* bias_row = bias + static_cast<long long>(batch) * n;

  load_tile<D>(sm.q, qb, row0, n, q_sn);
  load_tile<D>(sm.k[0], kb, 0, n, k_sn);
  load_tile<D>(sm.v[0], vb, 0, n, v_sn);
  load_bias(sm.bias[0], bias_row, 0, n);
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
      load_bias(sm.bias[buf ^ 1], bias_row, next, n);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just requested has landed
    __syncthreads();

    if (j == 0) load_a_frags<D>(qf, sm.q, warp, lane);

    // S = Qs K^T + bias for this warp's 16 rows and the tile's 64 keys;
    // key columns at or beyond n are masked out.
    float s[kBlockN / 8][4];
    product_abt<D>(s, qf, sm.k[buf], lane);
    const long long col0 = static_cast<long long>(j) * kBlockN;
    add_bias(s, sm.bias[buf], lane);
    fill_cols_from(s, col0, n, lane, -INFINITY);

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
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int c = 2 * r; c < 2 * r + 2; ++c) {
          // a masked key that ties with m must give exactly 1: subtract
          // first (fmaf(s, log2e, -m log2e) rounds m log2e apart from s)
          const float p = exp2f((s[nt][c] - mx) * kLog2e);
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
      lse[(static_cast<long long>(batch) * heads + head) * n + row] =
          m[r] <= kNegInf ? INFINITY : m[r] + logf(l[r]);
    }
  }
  store_rows<D>(o + batch * o_sb + head * o_sh, o_sn, row0, n, acc, warp, lane);
}

template <int D>
cudaError_t launch_bias(const void* q, const void* k, const void* v, const void* bias, void* o,
                        void* lse, long long batch, long long n, long long heads,
                        const long long (&s)[12], cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kBlockM - 1) / kBlockM),
                  static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  flash_fwd_bias_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(o), static_cast<float*>(lse),
      static_cast<int>(n), static_cast<int>(heads), s[0], s[1], s[2], s[3], s[4], s[5],
      s[6], s[7], s[8], s[9], s[10], s[11]);
  return cudaGetLastError();
}

// Encodes the four tensor maps and launches the Hopper kernel; returns a
// cudaError_t, or the CUresult of a map that cuTensorMapEncodeTiled refused.
int launch_unmasked(const void* q, const void* k, const void* v, void* o, void* lse,
                    long long batch, long long n, long long heads, const long long (&s)[12],
                    cudaStream_t stream) {
  if (!FwdCta::shape_ok(batch, n, heads)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const attn::Strides st[4] = {{s[0], s[1], s[2]}, {s[3], s[4], s[5]},
                               {s[6], s[7], s[8]}, {s[9], s[10], s[11]}};
  const CUresult r = FwdCta::encode_qkvo(maps, q, k, v, o, batch, n, heads, st);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  int grid = 0;
  cudaError_t err = FwdCta::prepare(flash_fwd_sm90, batch, n, heads, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_sm90<<<grid, FwdCta::kThreads, FwdCta::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<float*>(lse), static_cast<int>(n),
      static_cast<int>(heads), static_cast<int>(batch));
  return static_cast<int>(cudaGetLastError());
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
  if (bias == nullptr && head_dim == 64) {
    return launch_unmasked(q, k, v, o, lse, batch, n, heads, s, st);
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (bias != nullptr && head_dim == 64) {
    err = launch_bias<64>(q, k, v, bias, o, lse, batch, n, heads, s, st);
  } else if (bias != nullptr && head_dim == 32) {
    err = launch_bias<32>(q, k, v, bias, o, lse, batch, n, heads, s, st);
  }
  return static_cast<int>(err);
}

// q [64, 64], k and v [128, 64]: contiguous bf16.  s [64, 128] = q k^T and
// o [64, 64] = bf16(s) v, f32, from one warpgroup of the unmasked kernel's
// products.
extern "C" int bvc_attn_tile_check(const void* q, const void* k, const void* v, void* s, void* o,
                                   void* stream) {
  CUtensorMap maps[3];
  const attn::EncodeTiled encode = attn::encode_tiled();
  if (encode == nullptr) return static_cast<int>(CUDA_ERROR_NOT_SUPPORTED);
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {64, 128, 128};
  for (int i = 0; i < 3; ++i) {
    const attn::Strides st = {rows[i] * 64ll, 64, 64};
    const CUresult r = attn::encode_map(encode, &maps[i], ptrs[i], 1, rows[i], 1, st, rows[i]);
    if (r != CUDA_SUCCESS) return static_cast<int>(r);
  }
  cudaError_t err = cudaFuncSetAttribute(attn_tile_check_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         FwdCta::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_tile_check_kernel<<<1, 128, FwdCta::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(s), static_cast<float*>(o));
  return static_cast<int>(cudaGetLastError());
}
