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
//   slices; here N is not padded, each key tile's 128 biases are staged in
//   shared memory beside its K tile, and key columns at or beyond N get
//   -inf, so that they never tie with masked real keys.  The softmax runs in
//   base 2 on s = S log2 e + bias log2 e (one fmaf), p = exp2(s - m): a row
//   whose every key is masked scores -1e30 log2 e on all of them (the bias
//   swamps the product), ties with m and gets uniform weights over its N
//   keys, as plain attention gives; its LSE is stored as +inf, so the
//   backward gives it P = 0 and no gradient.
//
// Bound.  At the extraction shape [B, 1568, 12, 64] the work per clip is
// 4*h*N^2*d = 7.55 GFLOP of tensor-core products (7.6 us at 989 TFLOP/s)
// against 9.6 MB of q/k/v/o traffic (2.9 us at 3.35 TB/s) and 29.5 M
// exponentials, 7.0 us at 16 a clock on each of 132 SMs at 1.98 GHz: the
// exponentials weigh almost as much as the products, so the kernel reaches
// its bound only if one warpgroup's exponentials run beside another's
// products.  At JEPA's masked shapes (169 and 199 tokens) the products per
// byte fall with N: bound by bytes, of which a key tile whose every key is
// masked need not move any.
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
// Design, key bias (d = 64 and 32): the same mainloop (flash_fwd_bias_sm90,
// templated on the width), with three consumers (192-query tiles, 169
// tokens in one) at d = 64 and two (128-query tiles, 199 tokens in two) at
// d = 32, and Q double-buffered, since a work item takes one or two key
// tiles.  The producer is a whole warp: for each work item it reads the
// batch element's bias row, skips every key tile whose keys are all masked
// (exact: such a tile adds 0 to every row that has an attendable key; a
// batch element with no attendable key takes every tile, so its rows stay
// uniform), hands the consumers the count of tiles it will load beside the
// Q tile, and stages each loaded K tile's 128 biases (x log2 e, -inf past
// N) in shared memory beside it.  JEPA's collator pads the context at its
// end, so at 169 tokens its second key tile is dead whenever fewer than
// 128 keys are kept; the predictor's padding lies inside, and no tile dies.
//
// The library has a plain C interface, loaded with ctypes: pointers and the
// stream are passed as void*, sizes and strides (in elements) as long long;
// a null bias selects the unmasked kernel.  Each tensor is read through its
// strides; the innermost (head-width) stride must be 1 and every row must
// start on a 16-byte boundary, which the Python wrapper checks.  The bias is
// a contiguous [B, N] f32 row per batch element.  bvc_attn_tile_check runs
// the forward's two products on one tile at head width 64 or 32, for a
// first check on a new card or toolkit.

#include "attn_sm90.cuh"

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

// One warpgroup at head width D: S [64 x 128] = Q K^T from TMA-loaded
// tiles on wgmma, then O [64 x D] = bf16(S) V with P from registers and V
// transposed, both written as f32 rows.
template <int D>
__global__ void __launch_bounds__(128, 1)
attn_tile_check_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, float* __restrict__ s_out,
                       float* __restrict__ o_out) {
  using namespace attn;
  extern __shared__ unsigned char smem_raw[];
  FwdCta::Smem& sm = FwdCta::smem_of(smem_raw);  // tiles at d = 64 hold those at 32
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.q_full, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(&sm.q_full, Width<D>::kHalfBytes + 2 * Width<D>::kTileBytes);
    hopper::tma_load_4d(sm.q, &map_q, 0, 0, 0, 0, &sm.q_full);
    hopper::tma_load_4d(sm.k[0], &map_k, 0, 0, 0, 0, &sm.q_full);
    hopper::tma_load_4d(sm.v[0], &map_v, 0, 0, 0, 0, &sm.q_full);
  }
  hopper::mbar_wait(&sm.q_full, 0);

  float s[64], o[D / 2];
  uint32_t p[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  hopper::wgmma_fence();
  issue_s<D>(s, hopper::smem_addr(sm.q), hopper::smem_addr(sm.k[0]));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_operands(s);
  const int row = 16 * warp + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 64; ++i) s_out[(row + 8 * half_of(i)) * kBlockN + col_of(i, t)] = s[i];

  pack_p(p, s);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  hopper::fence_operands(o);
  hopper::wgmma_fence();
  issue_pv<D>(o, p, hopper::smem_addr(sm.v[0]));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_operands(o);
  hopper::fence_operands(p);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_out[(row + 8 * half_of(i)) * D + col_of(i, t)] = o[i];
}

// ---- key bias, d = 64 and 32: Hopper -------------------------------------

// The key-bias forward at head width D on the mainloop's pieces: three
// consumers (192-query tiles) at d = 64, two (128-query tiles) at d = 32,
// which cover JEPA's 169 context tokens in one tile and its 199 predictor
// tokens in two; Q double-buffered, since a work item takes only one or two
// key tiles and a single Q buffer would leave each item's Q load exposed.
template <int D>
struct BiasFwd {
  static constexpr int kConsumers = D == 64 ? 3 : 2;
  using C = attn::Cta<kConsumers, D>;
  static constexpr int kQStages = 2;
  // setmaxnreg's split: the producer warp stages the biases too
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = D == 64 ? 152 : 232;

  struct Smem {  // at a 1024-byte aligned base: every tile on a swizzle atom
    unsigned char q[kQStages][C::kQBytes];
    unsigned char k[attn::kStages][C::kTileBytes];
    unsigned char v[attn::kStages][C::kTileBytes];
    unsigned char o[kConsumers][C::kHalfBytes];  // each consumer's O, staged for TMA
    float kbias[attn::kStages][attn::kBlockN];   // the K tile's bias x log2 e, -inf past N
    int live[kQStages];  // how many key tiles the Q tile's work item takes
    uint64_t q_full[kQStages], q_empty[kQStages];
    uint64_t k_full[attn::kStages], k_empty[attn::kStages];
    uint64_t v_full[attn::kStages], v_empty[attn::kStages];
  };
  static constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;

  static __device__ __forceinline__ Smem& smem_of(unsigned char* raw) {
    return *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
  }

  // One thread.  k_full counts the producer warp's 32 arrivals, one after
  // each lane's bias stores (the first with the tile's TMA bytes).
  static __device__ __forceinline__ void init_barriers(Smem& sm) {
    for (int s = 0; s < kQStages; ++s) {
      hopper::mbar_init(&sm.q_full[s], 1);
      hopper::mbar_init(&sm.q_empty[s], 4 * kConsumers);
    }
    for (int s = 0; s < attn::kStages; ++s) {
      hopper::mbar_init(&sm.k_full[s], 32);
      hopper::mbar_init(&sm.v_full[s], 1);
      hopper::mbar_init(&sm.k_empty[s], 4 * kConsumers);
      hopper::mbar_init(&sm.v_empty[s], 4 * kConsumers);
    }
    hopper::mbar_init_fence();
  }

  // This lane's four biases of key tile t (keys t kBlockN + 32 j + lane),
  // times log2 e, -inf past N; returns, to the whole warp, whether any key
  // of the tile may be attended (bias above -1e30).
  static __device__ __forceinline__ bool tile_bias(const float* row, int t, int n, int lane,
                                                   float (&b)[4]) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = t * attn::kBlockN + 32 * j + lane;
      const float x = key < n ? row[key] : -INFINITY;
      any |= x > attn::kNegInf;
      b[j] = x * attn::kLog2e;
    }
    return __any_sync(0xffffffffu, any);
  }

  // How many of the key tiles t0 and t0 + 1 (those below n_tiles) have a key
  // that may be attended: this lane's eight keys loaded at once, then the
  // warp's votes, so that a row of up to 256 keys costs one trip to memory.
  static __device__ __forceinline__ int live_pair(const float* row, int t0, int n_tiles, int n,
                                                  int lane) {
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = t0 * attn::kBlockN + 32 * j + lane;
      x[j] = key < n ? row[key] : -INFINITY;
    }
    int live = 0;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      bool any = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) any |= x[4 * u + j] > attn::kNegInf;
      live += static_cast<int>(__any_sync(0xffffffffu, any) && t0 + u < n_tiles);
    }
    return live;
  }

  // The producer warp.  For each of the CTA's query tiles: the key tiles it
  // takes (those with a key that may be attended; all of them where no key
  // of the batch element may be, whose rows are then uniform over its N
  // keys), their count beside the Q tile, then those K and V tiles, last
  // first, each K tile's biases staged beside it by the 32 lanes.  K and V
  // tiles go in pairs, so one ring position serves both rings.
  static __device__ __forceinline__ void produce(Smem& sm, const CUtensorMap* map_q,
                                                 const CUtensorMap* map_k,
                                                 const CUtensorMap* map_v, const float* bias,
                                                 const typename C::Work& work, int n,
                                                 int n_tiles, int lane) {
    attn::Ring kv;
    attn::StageRing<kQStages> qr;
    for (int w = blockIdx.x; w < work.tiles; w += gridDim.x) {
      const int head = work.head(w);
      const int batch = work.batch(w);
      const float* row = bias + static_cast<long long>(batch) * n;
      const int next = w + static_cast<int>(gridDim.x);
      if (next < work.tiles) {  // the next item's bias row into L1, one line a lane
        const float* ahead = bias + static_cast<long long>(work.batch(next)) * n;
        for (int key = 32 * lane; key < n; key += 32 * 32) {
          asm volatile("prefetch.global.L1 [%0];" :: "l"(ahead + key));
        }
      }
      int n_live = 0;
      for (int t0 = 0; t0 < n_tiles; t0 += 2) n_live += live_pair(row, t0, n_tiles, n, lane);
      const bool every = n_live == 0;
      if (every) n_live = n_tiles;
      hopper::mbar_wait(&sm.q_empty[qr.stage], qr.phase ^ 1);
      if (lane == 0) {
        sm.live[qr.stage] = n_live;
        hopper::mbar_arrive_expect_tx(&sm.q_full[qr.stage], C::kQBytes);
        hopper::tma_load_4d(sm.q[qr.stage], map_q, 0, work.row0(w), head, batch,
                            &sm.q_full[qr.stage]);
      }
      qr.advance();
      for (int i = 0; i < n_tiles; ++i) {
        const int t = n_tiles - 1 - i;
        float b[4];
        if (!tile_bias(row, t, n, lane, b) && !every) continue;
        const int st = kv.stage;
        hopper::mbar_wait(&sm.k_empty[st], kv.phase ^ 1);  // passes at once on lap 0
#pragma unroll
        for (int j = 0; j < 4; ++j) sm.kbias[st][32 * j + lane] = b[j];
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&sm.k_full[st], C::kTileBytes);
          hopper::tma_load_4d(sm.k[st], map_k, 0, t * attn::kBlockN, head, batch, &sm.k_full[st]);
          hopper::mbar_wait(&sm.v_empty[st], kv.phase ^ 1);
          hopper::mbar_arrive_expect_tx(&sm.v_full[st], C::kTileBytes);
          hopper::tma_load_4d(sm.v[st], map_v, 0, t * attn::kBlockN, head, batch, &sm.v_full[st]);
        }
        hopper::mbar_arrive_if(&sm.k_full[st], lane != 0);
        kv.advance();
      }
    }
  }
};

template <int D>
__global__ void __launch_bounds__(BiasFwd<D>::C::kThreads, 1)
flash_fwd_bias_sm90(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_o, const float* __restrict__ bias,
                    float* __restrict__ lse, int n, int heads, int batches) {
  using namespace attn;
  using F = BiasFwd<D>;
  using C = typename F::C;
  extern __shared__ unsigned char smem_raw[];
  typename F::Smem& sm = F::smem_of(smem_raw);
  const int n_tiles = (n + kBlockN - 1) / kBlockN;  // key tiles
  const typename C::Work work = C::work(n, heads, batches);
  // warp-uniform by construction, so that ptxas sees each role's wgmma on a
  // path no warp diverges into
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) F::init_barriers(sm);
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<F::kProducerRegs>();
    if (threadIdx.x < 32) {
      F::produce(sm, &map_q, &map_k, &map_v, bias, work, n, n_tiles, threadIdx.x);
    }
    return;
  }
  hopper::setmaxnreg_inc<F::kConsumerRegs>();
  const int c = wg - 1;
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;

  float s[64], o[D / 2];
  uint32_t p[32];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;

  // s = S log2 e + bias log2 e of its key (from the K tile's staged row;
  // an S entry's column is 8 j + 2 t (+ 1) for s[4 j .. 4 j + 3]).
  auto add_bias = [&](const float* kb) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(kb + 8 * j + 2 * t);
      s[4 * j] = fmaf(s[4 * j], kLog2e, b.x);
      s[4 * j + 1] = fmaf(s[4 * j + 1], kLog2e, b.y);
      s[4 * j + 2] = fmaf(s[4 * j + 2], kLog2e, b.x);
      s[4 * j + 3] = fmaf(s[4 * j + 3], kLog2e, b.y);
    }
  };

  // The softmax of a scored tile, in place, in base 2: the new running max,
  // O and l rescaled by alpha to it, p = exp2(s - m), l.  m starts at
  // -inf: a row whose keys are all masked scores -1e30 log2 e on each (the
  // bias swamps the product), so its max is that, and p = exp2(0) = 1
  // gives it uniform weights over its N keys.  Two max chains and one sum
  // chain a row half: at three consumers every register counts.
  auto softmax = [&]() {
    float part[2][2] = {{m[0], m[0]}, {m[1], m[1]}};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float& x = part[half_of(i)][i & 1];
      x = fmaxf(x, s[i]);
    }
    float mx[2] = {fmaxf(part[0][0], part[0][1]), fmaxf(part[1][0], part[1][1])};
    quad_max(mx);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] *= alpha[half_of(j)];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      s[i] = ex2(s[i] - mx[half_of(i)]);
      l[half_of(i)] += s[i];
    }
  };

  // Each key tile takes two turns at the tensor cores, S then P V, with its
  // softmax between them while the other consumers' products run; nothing
  // is in flight across the loop's back edge.  (Overlapping one tile's S
  // with the last one's P V would hold S, P and O at once: at three
  // consumers, 128 registers a thread, that spills.)
  Ring kv;
  StageRing<F::kQStages> qr;
  C::turn_pass_if(c, c == C::kLast);
  for (int w = blockIdx.x; w < work.tiles; w += gridDim.x) {
    const bool last = w + static_cast<int>(gridDim.x) >= work.tiles;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    hopper::fence_operands(o);
    hopper::mbar_wait(&sm.q_full[qr.stage], qr.phase);
    const int n_live = __shfl_sync(0xffffffffu, sm.live[qr.stage], 0);
    const uint32_t q_addr = hopper::smem_addr(sm.q[qr.stage]) + c * C::kHalfBytes;

    for (int i = 0; i < n_live; ++i) {
      const int st = kv.stage;
      hopper::mbar_wait(&sm.k_full[st], kv.phase);
      C::turn_wait(c);
      hopper::wgmma_fence();
      issue_s<D>(s, q_addr, hopper::smem_addr(sm.k[st]));
      hopper::wgmma_commit();
      C::turn_pass_if(c, true);
      hopper::wgmma_wait<0>();
      hopper::fence_operands(s);
      add_bias(sm.kbias[st]);
      hopper::mbar_arrive_if(&sm.k_empty[st], lane == 0);
      // the last product that reads Q has landed: the producer may load the next
      hopper::mbar_arrive_if(&sm.q_empty[qr.stage], lane == 0 && i + 1 == n_live);
      softmax();  // O rescaled to this tile's running max
      pack_p(p, s);

      hopper::mbar_wait(&sm.v_full[st], kv.phase);
      C::turn_wait(c);
      hopper::wgmma_fence();
      issue_pv<D>(o, p, hopper::smem_addr(sm.v[st]));
      hopper::wgmma_commit();
      C::turn_pass_if(c, c != C::kLast || !last || i + 1 < n_live);
      hopper::wgmma_wait<0>();
      hopper::fence_operands(o);
      hopper::fence_operands(p);
      hopper::mbar_arrive_if(&sm.v_empty[st], lane == 0);
      kv.advance();
    }
    qr.advance();

    row_sum(l);
    const int row0 = work.row0(w);
    const int head = work.head(w);
    const int batch = work.batch(w);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv_l = 1.f / l[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * r] *= inv_l;
        o[4 * j + 2 * r + 1] *= inv_l;
      }
      const int row = row0 + 64 * c + 16 * warp + (lane >> 2) + 8 * r;
      if (t == 0 && row < n) {
        // a row with no attendable key: +inf, so the backward's P is 0
        lse[(static_cast<long long>(batch) * heads + head) * n + row] =
            m[r] <= kNegInf * kLog2e ? INFINITY : m[r] * kLn2 + logf(l[r]);
      }
    }
    C::store_o(sm.o[c], o, &map_o, row0 + 64 * c, head, batch, c, warp, lane);
  }
  hopper::bulk_wait_all();  // the stores read shared memory that lives as long as the CTA
}

// Encodes the four tensor maps and launches the key-bias kernel at head
// width D; returns a cudaError_t, or the CUresult of a refused map.
template <int D>
int launch_bias(const void* q, const void* k, const void* v, const void* bias, void* o,
                void* lse, long long batch, long long n, long long heads,
                const long long (&s)[12], cudaStream_t stream) {
  using F = BiasFwd<D>;
  using C = typename F::C;
  if (!C::shape_ok(batch, n, heads)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const attn::Strides st[4] = {{s[0], s[1], s[2]}, {s[3], s[4], s[5]},
                               {s[6], s[7], s[8]}, {s[9], s[10], s[11]}};
  const CUresult r = C::encode_qkvo(maps, q, k, v, o, batch, n, heads, st);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  int grid = 0;
  cudaError_t err = C::prepare(flash_fwd_bias_sm90<D>, batch, n, heads, &grid, F::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_bias_sm90<D><<<grid, C::kThreads, F::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(bias),
      static_cast<float*>(lse), static_cast<int>(n), static_cast<int>(heads),
      static_cast<int>(batch));
  return static_cast<int>(cudaGetLastError());
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
  if (bias != nullptr && head_dim == 64) {
    return launch_bias<64>(q, k, v, bias, o, lse, batch, n, heads, s, st);
  }
  if (bias != nullptr && head_dim == 32) {
    return launch_bias<32>(q, k, v, bias, o, lse, batch, n, heads, s, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {

template <int D>
int tile_check(const void* q, const void* k, const void* v, void* s, void* o,
               cudaStream_t stream) {
  CUtensorMap maps[3];
  const attn::EncodeTiled encode = attn::encode_tiled();
  if (encode == nullptr) return static_cast<int>(CUDA_ERROR_NOT_SUPPORTED);
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {64, 128, 128};
  for (int i = 0; i < 3; ++i) {
    const attn::Strides st = {rows[i] * static_cast<long long>(D), D, D};
    const CUresult r = attn::encode_map(encode, &maps[i], ptrs[i], 1, rows[i], 1, st, rows[i], D);
    if (r != CUDA_SUCCESS) return static_cast<int>(r);
  }
  cudaError_t err = cudaFuncSetAttribute(attn_tile_check_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         FwdCta::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_tile_check_kernel<D><<<1, 128, FwdCta::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(s), static_cast<float*>(o));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [64, d], k and v [128, d]: contiguous bf16, d = 64 or 32.  s [64, 128] =
// q k^T and o [64, d] = bf16(s) v, f32, from one warpgroup of the
// forward's products at that width.
extern "C" int bvc_attn_tile_check(const void* q, const void* k, const void* v, void* s, void* o,
                                   long long head_dim, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return tile_check<64>(q, k, v, s, o, st);
  if (head_dim == 32) return tile_check<32>(q, k, v, s, o, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
