// Backward flash attention for Hopper (sm_90a), without a key mask at head
// width 64 and with a per-sample key bias at head widths 64 and 32: bf16
// pre-scaled queries Qs, keys K, values V, output O and its gradient dO,
// the forward's f32 log-sum-exp L; bf16 dQs, dK and dV.
//
// Replaces bvc_tpu/ops/flash_attention.py::_dq_kernel and ::_dkv_kernel, and
// their key-bias variants ::_dq_kernel_bias and ::_dkv_kernel_bias (all
// launched from _bwd, with D = rowsum(dO * O) computed before them; the
// bias gets no gradient, as _flash_b_bwd_rule gives it none):
//
//   P = exp(Qs K^T + bias[key] - L),  dS = P * (dO V^T - D),
//   dQs = dS K,  dK = dS^T Qs,  dV = P^T dO.
//
// The same arithmetic as the TPU kernels: f32 scores, P rounded to bf16
// before the dV product, dS rounded to bf16 before the dQ and dK products,
// f32 sums, bf16 outputs.  No scale appears: Qs carries it, and autograd
// takes it through qs = q * scale into dQ (dK gets none).  Key columns at or
// beyond N get -1e30 before the exponential, as _kmask does; here that is
// P = 0 set directly (exp(-1e30 - L) is 0 for every finite L), and query
// rows at or beyond N get P = 0 as well, so they add nothing.  With a bias,
// a masked key (-1e30) gets P = exp2(-1e30 log2 e - ...) = 0 exactly for
// every row, and a row with no attendable key has L = +inf and P = 0: masked
// keys get dK = dV = 0 exactly, and such a row no gradient.  dQs is summed
// over the key tiles in f32 by TMA reductions (adds in L2) and rounded to
// bf16 once, as the TPU's accumulator is; only the order of those f32 adds
// differs from run to run, so two runs agree to f32 rounding, not
// necessarily bit for bit.
//
// Three kernels, launched one after another on one stream, each templated on
// the head width d (and the fused kernel on the bias):
// - flash_bwd_prep: D = rowsum(dO * O) in f32, reading O and dO once, and
//   L log2 e beside it (+inf stays +inf), into a [B h, 2, Np] f32 table
//   (Np = N rounded up to 64, zeros past N), and the f32 dQ accumulator
//   [B, h, Np, d] zeroed.
// - flash_bwd_sm90: the five products, one CTA per 128-key tile of a (head,
//   batch element).  With a bias, a CTA whose keys are all masked writes
//   zero dK and dV and adds nothing to dQ, which is exact: P = 0 there.
// - flash_bwd_dq_store: dQs as bf16 [B, N, h, d] from the accumulator.
//
// Bound.  Five N x N x d products, 10 B h N^2 d operations: at the
// decoder's [8, 1568, 6, 64] 75.5 GFLOP, 0.0764 ms at 989 TFLOP/s, against
// 68 MB of traffic (qs, k, v, dO, dQ, dK, dV in bf16, L and D in f32;
// 0.020 ms at 3.35 TB/s): bound by operations.  At the encoder's
// [8, 160, 12, 64] the products shrink with N^2 and bytes bound it
// (0.0041 ms), as at JEPA's key-bias shapes [64, 169, 12, 64] and
// [256, 199, 12, 32], where a masked key need not be read at all.  The split
// designs it replaces did seven products, since their dQ kernels recomputed
// S and dP.
//
// Design (FA3's backward shape, on attn_sm90.cuh's pieces).  A CTA of a
// producer warpgroup and two consumer warpgroups holds one 128-key tile of
// K and V (loaded once by TMA) and walks the queries in 64-row tiles:
// - The producer thread streams each query tile's Qs, dO and its 64 (L
//   log2 e, D) pairs through a 3-stage ring (a full and an empty mbarrier
//   per stage, the empty ones counting one arrival per consumer warp).
// - Consumer c owns keys [64 c, 64 c + 64) of the tile, whose K and V rows
//   it keeps in registers as wgmma A fragments.  It computes the TRANSPOSED
//   scores S^T = K_c Qs^T and dP^T = V_c dO^T (m64n64, Qs and dO K-major in
//   shared memory), so P^T and dS^T sit in accumulator registers in the
//   layout of a register A operand: dV_c += P^T dO and dK_c += dS^T Qs read
//   them from there, with dO and Qs MN-major (transposed), as V is in the
//   forward.  Every product but dQ thus reads one operand from shared
//   memory, whose bandwidth (128 bytes a clock) m64n64 products with both
//   operands there would use up.
// - dS^T also goes to shared memory as bf16 (128-byte swizzled, the layout
//   TMA writes), double-buffered.  Once both consumers have staged their
//   halves, consumer c computes its d / 2 columns of dQs = dS K over all
//   128 keys (m64n32 at d = 64, m64n16 at d = 32; dS^T read as a transposed
//   A operand and K as an MN-major B at a d-byte column offset), stages them
//   as f32 and hands them to a TMA reduction into the f32 accumulator: rows
//   added in L2, where per-element atomic adds cost the kernel a tenth of
//   its time.
// - At d = 32 the K, V, Qs, dO, dK and dV tiles have 64-byte rows under the
//   64-byte swizzle; S^T and dP^T take two k-steps, and dV and dK are
//   m64n32.  With a bias each consumer thread's two key rows of S^T carry
//   fixed biases, read once: P^T = exp2(S^T log2 e + (bias - L) log2 e).
// - The two consumers take turns at the tensor cores (named barriers, as in
//   the forward): S^T and dP^T with the last tile's dQ, then dV, then dK,
//   each issued only after the other consumer has issued its own, so that
//   one consumer's exponentials and dS^T run beside the other's products.
//   The turn order also orders the dS^T halves: each consumer stages its
//   half before its third turn, so the next tile's first turn finds both.
//   Within a consumer, P^T's exponentials run while dP^T and the last dQ
//   are on the tensor cores, and dS^T is formed while dV's product runs.
// - ptxas serialises the products unless it sees no wgmma_wait under a
//   condition, roles that are warp-uniform (hence the __shfl_sync on the
//   warpgroup index) and accumulators read only while nothing is in flight
//   in a divergent branch (dQ is staged right after a full wait).
// - The epilogue stages dK_c and dV_c as bf16 in a dS buffer and hands
//   them to TMA stores, which clip the key rows past N.
// One CTA per key tile (624 at the decoder's shape, 4.7 waves of one a
// SM): the consumers' 240 registers a thread leave room for no second CTA.
// With a bias, each CTA first reads its 128 keys' biases (one a thread) and
// exits at once, after zeroing its dK and dV rows, when none may be
// attended: at JEPA's 169 context tokens the collator's padding at the end
// leaves the second key tile dead whenever fewer than 128 keys are kept.
//
// The library has a plain C interface, loaded with ctypes: pointers and the
// stream as void*, sizes and strides (in elements) as long long.  Tensors are
// read through their (batch, token, head) strides; the head-width stride
// must be 1 and rows must start on 16 bytes.  L is contiguous [B, h, N] f32.
// Each entry point returns a cudaError_t (or the CUresult of a tensor map
// that cuTensorMapEncodeTiled refused), 0 on success; a null bias selects
// the unmasked kernel.  The bias is a contiguous [B, N] f32 row per batch
// element.  bvc_flash_bwd_tile_check runs the five products on one tile at
// head width 64 or 32, for a first check on a new card or toolkit.

#include <type_traits>

#include "attn_sm90.cuh"

namespace {

using attn::bf16;
using attn::col_of;
using attn::half_of;
using attn::kLog2e;
using attn::pack_bf16;

constexpr int kBlockN = attn::kBlockN;      // keys per CTA: 128
constexpr int kBlockM = 64;                 // queries per streamed tile
constexpr int kStages = 3;                  // depth of the query ring
constexpr int kStatBytes = 2 * kBlockM * 4;    // (L log2 e, D) of a query tile
constexpr int kDsBytes = kBlockN * kBlockM * 2;  // dS^T [128 keys x 64 queries] bf16: 16 KB
constexpr int kThreads = 3 * 128;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// named barriers (0 is __syncthreads): kTurnBar + c lets consumer c issue
// its products; kStageBar + c gathers consumer c's staged dQ, dK or dV;
// kEndBar gathers both consumers once their last products have landed
constexpr int kTurnBar = 1;
constexpr int kStageBar = 3;
constexpr int kEndBar = 5;

// Sizes at head width D (64 or 32).
template <int D>
struct Bwd {
  static constexpr int kRowBytes = attn::Width<D>::kRowBytes;  // a row of K, V, Qs, dO, dK, dV
  static constexpr int kTileBytes = attn::Width<D>::kTileBytes;  // K or V: 16 KB at d = 64
  static constexpr int kQTileBytes = kBlockM * kRowBytes;  // a Qs or dO tile: 8 KB at d = 64
  static constexpr int kHalfBytes = attn::Width<D>::kHalfBytes;  // 64 rows of K, V, dK or dV
  static constexpr int kDqRowBytes = D / 2 * 4;  // a consumer's dQ columns of a row, f32

  struct Smem {  // at a 1024-byte aligned base: every tile on a swizzle atom
    unsigned char k[kTileBytes];
    unsigned char v[kTileBytes];
    unsigned char q[kStages][kQTileBytes];
    unsigned char dout[kStages][kQTileBytes];
    unsigned char ds[2][kDsBytes];  // dS^T [128 keys x 64 queries], double-buffered, bf16
    unsigned char dqs[2][64 * kDqRowBytes];  // each consumer's dQ part [64 x d / 2] f32, for TMA
    float stats[kStages][2][kBlockM];  // L log2 e, then D, of a query tile
    uint64_t kv_full;
    uint64_t q_full[kStages], q_empty[kStages];
  };
  static constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;  // + alignment slack

  static __device__ __forceinline__ Smem& smem_of(unsigned char* raw) {
    return *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
  }
};

// A position in the query ring, and the parity of its lap.
using Ring = attn::StageRing<kStages>;

// D [64 x 64] = A B^T (S^T = K_c Qs^T, dP^T = V_c dO^T): A (the consumer's
// K or V rows) as bf16 A fragments in registers (load_a), B K-major in
// shared memory; the first k-step overwrites D.
template <int D>
__device__ __forceinline__ void issue_t(float (&d)[32], const uint32_t (&a)[D / 4],
                                        uint32_t b_addr) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    hopper::wgmma_m64n64k16_rs_kmajor(d, a[4 * ks], a[4 * ks + 1], a[4 * ks + 2],
                                      a[4 * ks + 3],
                                      hopper::desc_sw<Bwd<D>::kRowBytes>(b_addr + 32 * ks),
                                      ks > 0);
  }
}

// The A fragments of this warp's 16 rows of a 64 x D bf16 tile written by
// TMA with its swizzle: k-step ks, rows g and g + 8, columns 16 ks + 2 t
// (+ 1) and + 8 (the layout issue_acc's fragments have).
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 4], const unsigned char* tile, int warp,
                                       int lane) {
  constexpr int kRow = Bwd<D>::kRowBytes;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + g + 8 * (e & 1);
      const int chunk = 2 * ks + (e >> 1);
      // at 128-byte rows r % 8 = g: chunk ^ g, in the d = 64 kernel's own
      // expression, which ptxas schedules best
      const unsigned char* at = D == 64 ? tile + r * 128 + ((chunk ^ g) << 4)
                                        : tile + hopper::swizzle<kRow>(r * kRow + 16 * chunk);
      a[4 * ks + e] = *reinterpret_cast<const uint32_t*>(at + 4 * t);
    }
  }
}

// acc [64 keys x D] += X [64 keys x 64 queries] Y [64 queries x D]: X as
// bf16 A fragments (x[4 ks .. 4 ks + 3] for the queries [16 ks, 16 ks + 16)),
// Y MN-major, 16 rows (2048 bytes at d = 64, 1024 at d = 32) a k-step
// (dV += P^T dO, dK += dS^T Qs).
template <int D>
__device__ __forceinline__ void issue_acc(float (&acc)[D / 2], const uint32_t (&x)[16],
                                          uint32_t y_addr) {
#pragma unroll
  for (int ks = 0; ks < kBlockM / 16; ++ks) {
    if constexpr (D == 64) {
      hopper::wgmma_m64n64k16_rs(acc, x[4 * ks], x[4 * ks + 1], x[4 * ks + 2], x[4 * ks + 3],
                                 hopper::desc_sw128(y_addr + 2048 * ks));
    } else {
      hopper::wgmma_m64n32k16_rs(acc, x[4 * ks], x[4 * ks + 1], x[4 * ks + 2], x[4 * ks + 3],
                                 hopper::desc_sw<64>(y_addr + 1024 * ks));
    }
  }
}

// dQ [64 queries x D / 2] = dS [64 queries x 128 keys] K [128 keys x D / 2]:
// dS read from its transpose dS^T (keys down the rows, 128-byte rows), K
// from its tile at the consumer's D / 2 columns (k_addr already offset by D
// bytes a half), both MN-major, 16 key rows a k-step.
template <int D>
__device__ __forceinline__ void issue_dq(float (&dq)[D / 4], uint32_t ds_addr, uint32_t k_addr) {
#pragma unroll
  for (int ks = 0; ks < kBlockN / 16; ++ks) {
    if constexpr (D == 64) {
      hopper::wgmma_m64n32k16_tt(dq, hopper::desc_sw128(ds_addr + 2048 * ks),
                                 hopper::desc_sw128(k_addr + 2048 * ks), ks > 0);
    } else {
      hopper::wgmma_m64n16k16_tt(dq, hopper::desc_sw128(ds_addr + 2048 * ks),
                                 hopper::desc_sw<64>(k_addr + 1024 * ks), ks > 0);
    }
  }
}

// bf16 fragments of an m64nN accumulator (N entries a thread): x[i] holds
// entries 2 i and 2 i + 1, which is also the A-operand order (issue_acc).
template <int N>
__device__ __forceinline__ void pack(uint32_t (&x)[N / 2], const float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) x[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
}

// Writes this warp's 16 rows of a [64 x kRowBytes / 2] bf16 block
// (fragments of pack()) into `tile`, rows of kRowBytes under their swizzle
// (at 128 bytes, 16-byte chunk j of row r at chunk j ^ (r % 8)): the layout
// TMA and wgmma read.
template <int kRowBytes>
__device__ __forceinline__ void stage_rows(unsigned char* tile,
                                           const uint32_t (&x)[kRowBytes / 8], int warp,
                                           int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < kRowBytes / 8; ++i) {
    const int j = i >> 1;
    const int r = 16 * warp + g + 8 * (i & 1);
    unsigned char* at = kRowBytes == 128
                            ? tile + r * 128 + ((j ^ g) << 4)
                            : tile + hopper::swizzle<kRowBytes>(r * kRowBytes + 16 * j);
    *reinterpret_cast<uint32_t*>(at + 4 * t) = x[i];
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// ---- the kernels -----------------------------------------------------------

// One row (a query of one head and batch element) per 8 threads, each
// taking D / 8 of its D entries: D and L log2 e into the stats table (zeros
// for rows past N; L = +inf, a row with no attendable key, stays +inf), and
// the row of the dQ accumulator zeroed.  `rows` = B h Np, a multiple of 64,
// so a warp's four rows exit together.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep(const bf16* __restrict__ o, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ stats,
               float* __restrict__ dq_acc, int n, int np, int heads, long long rows,
               attn::Strides os, attn::Strides dos) {
  using Vec = std::conditional_t<D == 64, uint4, uint2>;  // D / 8 bf16 entries
  constexpr int kPer = D / 8;
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 3;
  const int part = threadIdx.x & 7;
  if (row >= rows) return;
  const long long bh = row / np;
  const int q = static_cast<int>(row - bh * np);
  const long long batch = bh / heads;
  const long long head = bh - batch * heads;
  float d = 0.f;
  if (q < n) {
    const Vec ov = *reinterpret_cast<const Vec*>(o + batch * os.b + q * os.n + head * os.h +
                                                 kPer * part);
    const Vec dv = *reinterpret_cast<const Vec*>(dout + batch * dos.b + q * dos.n +
                                                 head * dos.h + kPer * part);
    const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < kPer / 2; ++i) {
      const float2 x = __bfloat1622float2(a[i]);
      const float2 y = __bfloat1622float2(b[i]);
      d = fmaf(x.x, y.x, d);
      d = fmaf(x.y, y.y, d);
    }
  }
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  d += __shfl_xor_sync(0xffffffffu, d, 4);
  if (part == 0) {
    stats[2 * bh * np + q] = q < n ? lse[bh * n + q] * kLog2e : 0.f;
    stats[(2 * bh + 1) * np + q] = d;
  }
  float4* acc = reinterpret_cast<float4*>(dq_acc + row * D + kPer * part);
#pragma unroll
  for (int i = 0; i < kPer / 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// dQs [B, N, h, D] bf16 from the f32 accumulator, 8 threads a row.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dq_store(const float* __restrict__ dq_acc, bf16* __restrict__ dq, int n, int np,
                   int heads, long long rows, attn::Strides dqs) {
  constexpr int kPer = D / 8;
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 3;
  const int part = threadIdx.x & 7;
  if (row >= rows) return;
  const long long bh = row / np;
  const int q = static_cast<int>(row - bh * np);
  if (q >= n) return;
  const long long batch = bh / heads;
  const long long head = bh - batch * heads;
  const float4* acc = reinterpret_cast<const float4*>(dq_acc + row * D + kPer * part);
  uint32_t w[kPer / 2];
#pragma unroll
  for (int i = 0; i < kPer / 4; ++i) {
    const float4 x = acc[i];
    w[2 * i] = pack_bf16(x.x, x.y);
    w[2 * i + 1] = pack_bf16(x.z, x.w);
  }
  bf16* out = dq + batch * dqs.b + q * dqs.n + head * dqs.h + kPer * part;
  if constexpr (D == 64) {
    *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<uint2*>(out) = make_uint2(w[0], w[1]);
  }
}

template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_sm90(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_do,
               const __grid_constant__ CUtensorMap map_stats,
               const __grid_constant__ CUtensorMap map_dk,
               const __grid_constant__ CUtensorMap map_dv,
               const __grid_constant__ CUtensorMap map_dq, const float* __restrict__ bias,
               int n, int np) {
  using B = Bwd<D>;
  extern __shared__ unsigned char smem_raw[];
  typename B::Smem& sm = B::smem_of(smem_raw);
  const int key0 = blockIdx.x * kBlockN;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const long long bh = static_cast<long long>(batch) * gridDim.y + head;
  const int q_tiles = (n + kBlockM - 1) / kBlockM;
  const float* bias_row = kBias ? bias + static_cast<long long>(batch) * n : nullptr;

  if constexpr (kBias) {
    // A tile whose keys are all masked: P = 0 on every row, so zero dK and
    // dV rows (TMA stores of a zeroed staging, clipped at N) and no dQ.
    const int key = key0 + static_cast<int>(threadIdx.x);
    const bool live = threadIdx.x < kBlockN && key < n && bias_row[key] > attn::kNegInf;
    const int any = __syncthreads_or(live);
    if (__shfl_sync(0xffffffffu, any, 0) == 0) {  // warp-uniform by construction
      for (int i = threadIdx.x; i < B::kHalfBytes / 16; i += kThreads) {
        reinterpret_cast<uint4*>(sm.ds[0])[i] = make_uint4(0u, 0u, 0u, 0u);
      }
      hopper::fence_proxy_async();
      __syncthreads();
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool store = threadIdx.x == 0 && key0 + 64 * c < n;
        hopper::tma_store_4d_if(&map_dk, sm.ds[0], 0, key0 + 64 * c, head, batch, store);
        hopper::tma_store_4d_if(&map_dv, sm.ds[0], 0, key0 + 64 * c, head, batch, store);
      }
      hopper::bulk_commit();
      hopper::bulk_wait_all();
      return;
    }
  }
  // warp-uniform by construction, so that ptxas sees each role's wgmma on a
  // path no warp diverges into
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.q_full[s], 1);
      hopper::mbar_init(&sm.q_empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(&sm.kv_full, 2 * B::kTileBytes);
      hopper::tma_load_4d(sm.k, &map_k, 0, key0, head, batch, &sm.kv_full);
      hopper::tma_load_4d(sm.v, &map_v, 0, key0, head, batch, &sm.kv_full);
      Ring r;
      for (int i = 0; i < q_tiles; ++i) {
        hopper::mbar_wait(&sm.q_empty[r.stage], r.phase ^ 1);  // passes at once on lap 0
        uint64_t* full = &sm.q_full[r.stage];
        hopper::mbar_arrive_expect_tx(full, 2 * B::kQTileBytes + kStatBytes);
        hopper::tma_load_4d(sm.q[r.stage], &map_q, 0, kBlockM * i, head, batch, full);
        hopper::tma_load_4d(sm.dout[r.stage], &map_do, 0, kBlockM * i, head, batch, full);
        hopper::tma_load_2d(sm.stats[r.stage], &map_stats, kBlockM * i,
                            static_cast<int>(2 * bh), full);
        r.advance();
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t k_addr = hopper::smem_addr(sm.k);
  // this thread's two key rows of S^T (row halves), whether they are real,
  // and with a bias their biases times log2 e
  bool key_ok[2];
  float kb[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 64 * c + 16 * warp + g + 8 * r;
    key_ok[r] = key < n;
    if constexpr (kBias) kb[r] = key_ok[r] ? bias_row[key] * kLog2e : 0.f;
  }

  float dk[D / 2], dv[D / 2], st[32], dpt[32], dq[D / 4];
  zero(dk);
  zero(dv);
  zero(st);
  zero(dpt);
  zero(dq);
  hopper::fence_operands(dk);
  hopper::fence_operands(dv);
  hopper::mbar_wait(&sm.kv_full, 0);
  uint32_t kf[D / 4], vf[D / 4];
  load_a<D>(kf, sm.k + c * B::kHalfBytes, warp, lane);
  load_a<D>(vf, sm.v + c * B::kHalfBytes, warp, lane);

  // Turns at the tensor cores: consumer c issues its products once the
  // other has issued its own, so that one consumer's exponentials run while
  // the other's products do.  A tile takes three turns, and one more ends
  // the loop; consumer 1 passes once before its first turn, so consumer 0
  // goes first, and skips its last pass, which no turn would take.  The
  // order also stands in for a barrier on dS^T: each consumer stages its
  // half of tile i's dS^T before its third turn of tile i, so both halves
  // are in shared memory by either consumer's first turn of tile i + 1,
  // which issues tile i's dQ.
  auto turn_wait = [&]() { hopper::bar_sync<256>(kTurnBar + c); };
  auto turn_pass = [&](bool pred) { hopper::bar_arrive_if<256>(kTurnBar + (c ^ 1), pred); };
  // dQs[rows of query tile `tile`, D / 2 c + ...] += dq by a TMA reduction
  // from f32 staging (swizzled as the dq map's rows).  Rows past N add
  // zeros (their P^T columns are 0) into the accumulator's padding rows,
  // which the post-pass never reads.  dq is read right after the wait that
  // retires it, with nothing in flight (read beside pending products in a
  // branch, it made ptxas serialise them).
  auto add_dq = [&](int tile) {
    constexpr int kRow = B::kDqRowBytes;
    unsigned char* stage = sm.dqs[c];
    hopper::bulk_wait_read<0>();  // the last reduction has read the staging
    hopper::bar_sync<128>(kStageBar + c);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * warp + g + 8 * h;
        const int chunk = 2 * j + (t >> 1);
        unsigned char* at = kRow == 128 ? stage + row * 128 + ((chunk ^ g) << 4)
                                        : stage + hopper::swizzle<kRow>(row * kRow + 16 * chunk);
        *reinterpret_cast<float2*>(at + 8 * (t & 1)) =
            make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
      }
    }
    hopper::fence_proxy_async();
    hopper::bar_sync<128>(kStageBar + c);
    hopper::tma_reduce_add_2d_if(&map_dq, stage, D / 2 * c,
                                 static_cast<int>(bh * np + kBlockM * tile),
                                 warp == 0 && lane == 0);
    hopper::bulk_commit();
  };
  // dQ of the tile whose dS^T is in buffer `buf`, over all 128 keys
  auto issue_dq_of = [&](int buf) {
    issue_dq<D>(dq, hopper::smem_addr(sm.ds[buf]), k_addr + D * c);
    hopper::wgmma_commit();
  };

  Ring r;
  turn_pass(c == 1);
  for (int i = 0; i < q_tiles; ++i) {
    const int s = r.stage;
    const uint32_t q_addr = hopper::smem_addr(sm.q[s]);
    const uint32_t do_addr = hopper::smem_addr(sm.dout[s]);
    hopper::mbar_wait(&sm.q_full[s], r.phase);
    turn_wait();
    hopper::wgmma_fence();
    issue_t<D>(st, kf, q_addr);
    hopper::wgmma_commit();
    issue_t<D>(dpt, vf, do_addr);
    hopper::wgmma_commit();
    issue_dq_of((i + 1) & 1);  // the last tile's dQ (at i = 0, unused)
    turn_pass(true);
    hopper::wgmma_wait<2>();  // S^T has landed; dP^T and dQ run on
    hopper::fence_operands(st);

    // P^T = exp(S^T (+ bias[key]) - L[query]); keys and queries past N get 0.
    const int q_valid = n - kBlockM * i;
    const float* l2 = sm.stats[s][0];
    const float* dl = sm.stats[s][1];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = col_of(e, t);
      const float shift = kBias ? kb[half_of(e)] - l2[col] : -l2[col];
      const float p = exp2f(fmaf(st[e], kLog2e, shift));
      st[e] = col < q_valid && key_ok[half_of(e)] ? p : 0.f;
    }
    uint32_t x[16];
    pack<32>(x, st);
    turn_wait();
    hopper::wgmma_fence();
    issue_acc<D>(dv, x, do_addr);  // dV += P^T dO, P^T rounded to bf16
    hopper::wgmma_commit();
    turn_pass(true);
    hopper::wgmma_wait<2>();  // dP^T has landed; dQ and dV run on
    hopper::fence_operands(dpt);

    // dS^T = P^T (dP^T - D[query]), in place of P^T, staged in shared memory
    // for dQ: this consumer's 64 rows of buffer i % 2, which both
    // consumers' dQ products of tile i - 2 have finished reading.
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] *= dpt[e] - dl[col_of(e, t)];
    uint32_t y[16];
    pack<32>(y, st);
    stage_rows<128>(sm.ds[i & 1] + c * (kDsBytes / 2), y, warp, lane);
    hopper::fence_proxy_async();
    turn_wait();
    hopper::wgmma_fence();
    issue_acc<D>(dk, y, q_addr);  // dK += dS^T Qs, dS^T rounded to bf16
    hopper::wgmma_commit();
    turn_pass(true);
    hopper::wgmma_wait<0>();
    hopper::fence_operands(dq);
    hopper::fence_operands(dk);
    hopper::fence_operands(dv);
    hopper::fence_operands(x);
    hopper::fence_operands(y);
    // every product that reads this stage has landed: the producer may refill it
    hopper::mbar_arrive_if(&sm.q_empty[s], lane == 0);
    r.advance();
    if (i > 0) add_dq(i - 1);
  }
  // the last tile's dQ, in one more turn
  turn_wait();
  hopper::wgmma_fence();
  issue_dq_of((q_tiles - 1) & 1);
  turn_pass(c == 0);
  hopper::wgmma_wait<0>();
  hopper::fence_operands(dq);
  add_dq(q_tiles - 1);

  // dK and dV of this consumer's keys, staged as bf16 in a dS buffer (free
  // once both consumers' last dQ products have landed) and stored by TMA,
  // which clips the rows past N.
  hopper::bar_sync<256>(kEndBar);
  unsigned char* out = sm.ds[c];
  uint32_t x[D / 4];
  pack<D / 2>(x, dk);
  stage_rows<B::kRowBytes>(out, x, warp, lane);
  pack<D / 2>(x, dv);
  stage_rows<B::kRowBytes>(out + B::kHalfBytes, x, warp, lane);
  hopper::fence_proxy_async();
  hopper::bar_sync<128>(kStageBar + c);
  const bool store = warp == 0 && lane == 0 && key0 + 64 * c < n;
  hopper::tma_store_4d_if(&map_dk, out, 0, key0 + 64 * c, head, batch, store);
  hopper::tma_store_4d_if(&map_dv, out + B::kHalfBytes, 0, key0 + 64 * c, head, batch, store);
  hopper::bulk_commit();
  hopper::bulk_wait_all();  // the stores read shared memory that lives as long as the CTA
}

// Two consumer warpgroups at head width D, the five products of one tile
// from TMA-loaded qs, dO [64 x D], K and V [128 x D]: S^T = K qs^T and
// dP^T = V dO^T [128 x 64], then dV = bf16(S^T) dO, dK = bf16(dP^T) qs
// [128 x D] and dQ = bf16(dP^T)^T K [64 x D] (each consumer D / 2 of its
// columns), all written as f32 rows.
template <int D>
__global__ void __launch_bounds__(256, 1)
flash_bwd_tile_check_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_do, float* __restrict__ st_out,
                            float* __restrict__ dpt_out, float* __restrict__ dv_out,
                            float* __restrict__ dk_out, float* __restrict__ dq_out) {
  using B = Bwd<D>;
  extern __shared__ unsigned char smem_raw[];
  typename B::Smem& sm = B::smem_of(smem_raw);
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.kv_full, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(&sm.kv_full, 2 * B::kTileBytes + 2 * B::kQTileBytes);
    hopper::tma_load_4d(sm.k, &map_k, 0, 0, 0, 0, &sm.kv_full);
    hopper::tma_load_4d(sm.v, &map_v, 0, 0, 0, 0, &sm.kv_full);
    hopper::tma_load_4d(sm.q[0], &map_q, 0, 0, 0, 0, &sm.kv_full);
    hopper::tma_load_4d(sm.dout[0], &map_do, 0, 0, 0, 0, &sm.kv_full);
  }
  hopper::mbar_wait(&sm.kv_full, 0);
  const uint32_t q_addr = hopper::smem_addr(sm.q[0]);
  const uint32_t do_addr = hopper::smem_addr(sm.dout[0]);
  uint32_t kf[D / 4], vf[D / 4];
  load_a<D>(kf, sm.k + c * B::kHalfBytes, warp, lane);
  load_a<D>(vf, sm.v + c * B::kHalfBytes, warp, lane);

  float st[32], dpt[32], dv[D / 2], dk[D / 2], dq[D / 4];
  zero(dv);
  zero(dk);
  hopper::fence_operands(dv);
  hopper::fence_operands(dk);
  hopper::wgmma_fence();
  issue_t<D>(st, kf, q_addr);
  issue_t<D>(dpt, vf, do_addr);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_operands(st);
  hopper::fence_operands(dpt);
  const int row = 16 * warp + (lane >> 2);
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int at = (64 * c + row + 8 * half_of(e)) * kBlockM + col_of(e, t);
    st_out[at] = st[e];
    dpt_out[at] = dpt[e];
  }

  uint32_t x[16], y[16];
  pack<32>(x, st);
  pack<32>(y, dpt);
  stage_rows<128>(sm.ds[0] + c * (kDsBytes / 2), y, warp, lane);
  hopper::fence_proxy_async();
  hopper::bar_sync<256>(kEndBar);  // both halves of dS^T are in shared memory
  hopper::wgmma_fence();
  issue_acc<D>(dv, x, do_addr);
  issue_acc<D>(dk, y, q_addr);
  issue_dq<D>(dq, hopper::smem_addr(sm.ds[0]), hopper::smem_addr(sm.k) + D * c);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_operands(dq);
  hopper::fence_operands(dv);
  hopper::fence_operands(dk);
  hopper::fence_operands(x);
  hopper::fence_operands(y);
#pragma unroll
  for (int e = 0; e < D / 2; ++e) {
    const int at = (64 * c + row + 8 * half_of(e)) * D + col_of(e, t);
    dv_out[at] = dv[e];
    dk_out[at] = dk[e];
  }
#pragma unroll
  for (int e = 0; e < D / 4; ++e) {  // rows are queries, columns D / 2 c + ...
    dq_out[(row + 8 * half_of(e)) * D + D / 2 * c + col_of(e, t)] = dq[e];
  }
}

// ---- host ------------------------------------------------------------------

// A 2-D f32 map of `rows` rows of `inner` floats in boxes of `box_inner` x
// `box_rows`: the stats table [B h, 2, Np] as (Np, 2 B h) in boxes of 64
// queries x 2 rows (L log2 e, then D), unswizzled; the dQ accumulator
// [B h Np, d] in boxes of 64 rows x d / 2 floats, swizzled as their rows
// (128 bytes at d = 64, 64 at d = 32).
CUresult encode_f32_map(attn::EncodeTiled encode, CUtensorMap* map, const void* base,
                        long long inner, long long rows, cuuint32_t box_inner,
                        cuuint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner * 4)};
  const cuuint32_t box[2] = {box_inner, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Sizes the kernels take: at least one token, Np = N rounded up to 64, and
// accumulator rows (B h Np) numbered within 32 bits.
bool shape_ok(long long batch, long long n, long long heads, long long np) {
  return batch > 0 && n > 0 && heads > 0 && batch < 65536 && heads < 65536 &&
         np % kBlockM == 0 && np >= n && np < n + kBlockM && batch * heads * np < (1ll << 31);
}

unsigned rows_grid(long long rows) { return static_cast<unsigned>((rows * 8 + 255) / 256); }

template <int D>
int launch_prep(const void* o, const void* dout, const void* lse, void* stats, void* dq_acc,
                long long batch, long long n, long long heads, long long np, attn::Strides os,
                attn::Strides dos, cudaStream_t stream) {
  const long long rows = batch * heads * np;
  flash_bwd_prep<D><<<rows_grid(rows), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(stats), static_cast<float*>(dq_acc),
      static_cast<int>(n), static_cast<int>(np), static_cast<int>(heads), rows, os, dos);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kBias>
int launch_fused(const void* const (&ptrs)[6], const attn::Strides (&st)[6], const void* stats,
                 const void* bias, void* dq_acc, long long batch, long long n, long long heads,
                 long long np, cudaStream_t stream) {
  const attn::EncodeTiled encode = attn::encode_tiled();
  if (encode == nullptr) return static_cast<int>(CUDA_ERROR_NOT_SUPPORTED);
  CUtensorMap maps[8];
  const int rows[6] = {kBlockM, kBlockN, kBlockN, kBlockM, 64, 64};
  for (int i = 0; i < 6; ++i) {
    const CUresult r =
        attn::encode_map(encode, &maps[i], ptrs[i], batch, n, heads, st[i], rows[i], D);
    if (r != CUDA_SUCCESS) return static_cast<int>(r);
  }
  CUresult r = encode_f32_map(encode, &maps[6], stats, np, 2 * batch * heads, kBlockM, 2,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r == CUDA_SUCCESS) {
    r = encode_f32_map(encode, &maps[7], dq_acc, D, batch * heads * np, D / 2, 64,
                       D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_sm90<D, kBias>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Bwd<D>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + kBlockN - 1) / kBlockN),
                  static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  flash_bwd_sm90<D, kBias><<<grid, kThreads, Bwd<D>::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[6], maps[4], maps[5], maps[7],
      static_cast<const float*>(bias), static_cast<int>(n), static_cast<int>(np));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_store(const void* dq_acc, void* dq, long long batch, long long n, long long heads,
                    long long np, attn::Strides dqs, cudaStream_t stream) {
  const long long rows = batch * heads * np;
  flash_bwd_dq_store<D><<<rows_grid(rows), 256, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<bf16*>(dq), static_cast<int>(n),
      static_cast<int>(np), static_cast<int>(heads), rows, dqs);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int tile_check(const void* const (&ptrs)[4], float* const (&outs)[5], cudaStream_t stream) {
  const attn::EncodeTiled encode = attn::encode_tiled();
  if (encode == nullptr) return static_cast<int>(CUDA_ERROR_NOT_SUPPORTED);
  CUtensorMap maps[4];
  const int rows[4] = {64, 128, 128, 64};
  for (int i = 0; i < 4; ++i) {
    const attn::Strides s = {rows[i] * static_cast<long long>(D), D, D};
    const CUresult r = attn::encode_map(encode, &maps[i], ptrs[i], 1, rows[i], 1, s, rows[i], D);
    if (r != CUDA_SUCCESS) return static_cast<int>(r);
  }
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_tile_check_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Bwd<D>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_tile_check_kernel<D><<<1, 256, Bwd<D>::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], outs[0], outs[1], outs[2], outs[3], outs[4]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// D and L log2 e of every query into stats ([B h, 2, Np] f32), and the dQ
// accumulator ([B, h, Np, d] f32) zeroed; d = 64 or 32.
extern "C" int bvc_flash_bwd_prep(const void* o, const void* dout, const void* lse, void* stats,
                                  void* dq_acc, long long batch, long long n, long long heads,
                                  long long np, long long head_dim, long long o_sb,
                                  long long o_sn, long long o_sh, long long do_sb,
                                  long long do_sn, long long do_sh, void* stream) {
  if (!shape_ok(batch, n, heads, np)) return static_cast<int>(cudaErrorInvalidValue);
  const attn::Strides os = {o_sb, o_sn, o_sh}, dos = {do_sb, do_sn, do_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch_prep<64>(o, dout, lse, stats, dq_acc, batch, n, heads, np, os, dos, st);
  if (head_dim == 32) return launch_prep<32>(o, dout, lse, stats, dq_acc, batch, n, heads, np, os, dos, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The five products: dK and dV stored, dQs added into dq_acc.  A null bias
// selects the unmasked kernel, a [B, N] key bias the key-bias one; each at
// d = 64 or 32.
extern "C" int bvc_flash_bwd_sm90(const void* q, const void* k, const void* v, const void* dout,
                                  const void* stats, const void* bias, void* dk, void* dv,
                                  void* dq_acc, long long batch, long long n, long long heads,
                                  long long np, long long head_dim,
                                  long long q_sb, long long q_sn, long long q_sh,
                                  long long k_sb, long long k_sn, long long k_sh,
                                  long long v_sb, long long v_sn, long long v_sh,
                                  long long do_sb, long long do_sn, long long do_sh,
                                  long long dk_sb, long long dk_sn, long long dk_sh,
                                  long long dv_sb, long long dv_sn, long long dv_sh,
                                  void* stream) {
  if (!shape_ok(batch, n, heads, np)) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
  const attn::Strides st[6] = {{q_sb, q_sn, q_sh},    {k_sb, k_sn, k_sh},
                               {v_sb, v_sn, v_sh},    {do_sb, do_sn, do_sh},
                               {dk_sb, dk_sn, dk_sh}, {dv_sb, dv_sn, dv_sh}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias == nullptr && head_dim == 64) {
    return launch_fused<64, false>(ptrs, st, stats, bias, dq_acc, batch, n, heads, np, s);
  }
  if (bias == nullptr && head_dim == 32) {
    return launch_fused<32, false>(ptrs, st, stats, bias, dq_acc, batch, n, heads, np, s);
  }
  if (bias != nullptr && head_dim == 64) {
    return launch_fused<64, true>(ptrs, st, stats, bias, dq_acc, batch, n, heads, np, s);
  }
  if (bias != nullptr && head_dim == 32) {
    return launch_fused<32, true>(ptrs, st, stats, bias, dq_acc, batch, n, heads, np, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dQs [B, N, h, d] bf16 from the accumulator; d = 64 or 32.
extern "C" int bvc_flash_bwd_dq_store(const void* dq_acc, void* dq, long long batch, long long n,
                                      long long heads, long long np, long long head_dim,
                                      long long dq_sb, long long dq_sn, long long dq_sh,
                                      void* stream) {
  if (!shape_ok(batch, n, heads, np)) return static_cast<int>(cudaErrorInvalidValue);
  const attn::Strides dqs = {dq_sb, dq_sn, dq_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch_dq_store<64>(dq_acc, dq, batch, n, heads, np, dqs, s);
  if (head_dim == 32) return launch_dq_store<32>(dq_acc, dq, batch, n, heads, np, dqs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// qs, dout [64, d], k, v [128, d]: contiguous bf16, d = 64 or 32.  st, dpt
// [128, 64], dv, dk [128, d] and dq [64, d] f32, from the backward kernel's
// five products on one tile (see flash_bwd_tile_check_kernel).
extern "C" int bvc_flash_bwd_tile_check(const void* q, const void* k, const void* v,
                                        const void* dout, void* st, void* dpt, void* dv,
                                        void* dk, void* dq, long long head_dim, void* stream) {
  const void* ptrs[4] = {q, k, v, dout};
  float* const outs[5] = {static_cast<float*>(st), static_cast<float*>(dpt),
                          static_cast<float*>(dv), static_cast<float*>(dk),
                          static_cast<float*>(dq)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return tile_check<64>(ptrs, outs, s);
  if (head_dim == 32) return tile_check<32>(ptrs, outs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
