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
// two passes over 128-key tiles: the row max first (K alone), then exp, sum
// and P V, which computes the same function.  Keys at or beyond N score
// -inf, so N need not divide into tiles (the TPU padded the JEPA target's
// 392 to 512).  expf, not __expf or exp2 tricks, so that p agrees with
// torch.exp to ulps; O = acc / l by division, as the plain version divides.
//
// Bound.  The function takes 4 B h N^2 d tensor-core operations: 0.052 ms
// at [64, 12, 512, 64] and 0.183 ms at [48, 6, 1568, 64] at 989 TFLOP/s,
// above their q/k/v/o bytes at 3.35 TB/s; the two-pass design does 1.5x
// those operations (Qs K^T twice) to keep the function exact.  B h N^2
// exponentials (expf, dearer than flash_fwd's exp2f) weigh as much again,
// so the exponentials of one warpgroup have to run beside the products of
// the other.
//
// Design.  The Hopper mainloop of attn_sm90.cuh, as flash_fwd.cu's
// unmasked kernel but with two consumers: persistent CTAs of three
// warpgroups walking tiles of 128 queries, a TMA producer streaming K
// through its ring twice and V beside the second pass, two consumer
// warpgroups taking turns at the tensor cores.  Pass 1 scores every tile
// and keeps the row max; pass 2 scores again and overlaps the exponentials
// of a tile with the P V product of the one before, as flash_fwd.cu does.
//
// Plain C interface, loaded with ctypes: pointers and the stream as void*,
// sizes and strides (in elements, [B, h, N] order) as long long.  The
// innermost stride must be 1 and every row must start on 16 bytes, which
// the Python wrapper ensures.

#include "attn_sm90.cuh"

namespace {

using namespace attn;

// Rounds a and b to bf16 (to nearest, ties to even) with one packed
// conversion; returns the pair as packed bf16 and sets a and b to their
// values as f32.
__device__ __forceinline__ uint32_t round_pair(float& a, float& b) {
  const uint32_t u = pack_bf16(a, b);
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xffff0000u);
  return u;
}

// Two consumer warpgroups: the exponentials' registers leave no room for a
// third (160 registers a thread spill).
using ProbeCta = Cta<2>;

template <bool kBf16Scores>
__global__ void __launch_bounds__(ProbeCta::kThreads, 1)
softmax_probe_sm90(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_o, int n, int heads, int batches) {
  using C = ProbeCta;
  extern __shared__ unsigned char smem_raw[];
  C::Smem& sm = C::smem_of(smem_raw);
  const int n_tiles = (n + kBlockN - 1) / kBlockN;  // key tiles
  const C::Work work = C::work(n, heads, batches);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) C::init_barriers(sm);
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<C::kProducerRegs>();
    if (threadIdx.x == 0) C::produce(sm, &map_q, &map_k, &map_v, work, n_tiles, 2);
    return;
  }
  hopper::setmaxnreg_inc<C::kConsumerRegs>();
  const int c = wg - 1;
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const uint32_t q_addr = hopper::smem_addr(sm.q) + c * kHalfBytes;
  const int ragged = n - (n_tiles - 1) * kBlockN;  // keys of the last tile, scored first

  float s[64], o[32];
  uint32_t p[32];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;

  // p from a scored tile, in place (keys at or beyond n at -inf on the
  // ragged one), and l += sum p in f32.  f32 scores: p = exp(s - m).  bf16
  // scores, every step rounded: s = bf16(s), d = bf16(s - m), p =
  // bf16(exp(d)).  Entries 2i and 2i + 1 share a row and are rounded as a
  // pair.
  auto exponentials = [&](bool is_ragged) {
    if (is_ragged) mask_cols(s, ragged, t, -INFINITY);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float mr = m[half_of(2 * i)];
      float a = s[2 * i], b = s[2 * i + 1];
      if constexpr (kBf16Scores) {
        round_pair(a, b);
        a -= mr;
        b -= mr;
        round_pair(a, b);
        a = expf(a);
        b = expf(b);
        round_pair(a, b);
      } else {
        a = expf(a - mr);
        b = expf(b - mr);
      }
      s[2 * i] = a;
      s[2 * i + 1] = b;
      l[half_of(2 * i)] += a;
      l[half_of(2 * i)] += b;
    }
  };

  Ring kr, vr;
  uint32_t q_phase = 0;
  C::turn_pass_if(c, c == C::kLast);
  for (int w = blockIdx.x; w < work.tiles; w += gridDim.x) {
    const bool last = w + static_cast<int>(gridDim.x) >= work.tiles;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    hopper::fence_operands(o);
    hopper::mbar_wait(&sm.q_full, q_phase);
    q_phase ^= 1;

    // Pass 1: the row max, one S product a turn.
    for (int i = 0; i < n_tiles; ++i) {
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
      if (i == 0) mask_cols(s, ragged, t, -INFINITY);
      thread_max(s, m);
    }
    quad_max(m);
    if constexpr (kBf16Scores) {
      // the max of the rounded scores: rounding keeps the order
      round_pair(m[0], m[1]);
    }

    // Pass 2: the ragged tile with nothing else in flight, then S of a tile
    // beside P V of the one before.
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
    exponentials(true);
    pack_p(p, s);

    for (int i = 1; i < n_tiles; ++i) {
      hopper::mbar_wait(&sm.k_full[kr.stage], kr.phase);
      hopper::mbar_wait(&sm.v_full[vr.stage], vr.phase);
      C::turn_wait(c);
      hopper::wgmma_fence();
      issue_s(s, q_addr, hopper::smem_addr(sm.k[kr.stage]));
      hopper::wgmma_commit();
      issue_pv(o, p, hopper::smem_addr(sm.v[vr.stage]));
      hopper::wgmma_commit();
      C::turn_pass_if(c, true);
      hopper::wgmma_wait<1>();
      hopper::fence_operands(s);
      hopper::mbar_arrive_if(&sm.k_empty[kr.stage], lane == 0);
      kr.advance();
      exponentials(false);
      hopper::wgmma_wait<0>();
      hopper::fence_operands(o);
      hopper::fence_operands(p);
      hopper::mbar_arrive_if(&sm.v_empty[vr.stage], lane == 0);
      vr.advance();
      pack_p(p, s);  // exact for bf16 scores, whose p is already bf16
    }
    hopper::mbar_arrive_if(&sm.q_empty, lane == 0);

    hopper::mbar_wait(&sm.v_full[vr.stage], vr.phase);
    C::turn_wait(c);
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
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = __fdiv_rn(o[i], l[half_of(i)]);
    C::store_o(sm.o[c], o, &map_o, work.row0(w) + 64 * c, work.head(w), work.batch(w), c, warp,
            lane);
  }
  hopper::bulk_wait_all();  // the stores read shared memory that lives as long as the CTA
}

template <bool kBf16Scores>
int launch(const void* q, const void* k, const void* v, void* o, long long batch,
           long long heads, long long n, const long long (&s)[12], cudaStream_t stream) {
  CUtensorMap maps[4];
  const Strides st[4] = {{s[0], s[2], s[1]}, {s[3], s[5], s[4]},
                         {s[6], s[8], s[7]}, {s[9], s[11], s[10]}};
  const CUresult r = ProbeCta::encode_qkvo(maps, q, k, v, o, batch, n, heads, st);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  const auto kernel = softmax_probe_sm90<kBf16Scores>;
  int grid = 0;
  const cudaError_t err = ProbeCta::prepare(kernel, batch, n, heads, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, ProbeCta::kThreads, ProbeCta::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<int>(n), static_cast<int>(heads),
      static_cast<int>(batch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16_scores 0: f32 score arithmetic; 1: bf16.  Strides are (batch, head,
// token) of each [B, h, N, 64] tensor.  Any head width but 64, and any size
// the grid cannot take, is refused with cudaErrorInvalidValue before
// anything launches; a tensor map that cannot be encoded, with its
// CUresult.
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
  if (head_dim != attn::kD || !ProbeCta::shape_ok(batch, n, heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16_scores ? launch<true>(q, k, v, o, batch, heads, n, s, st)
                     : launch<false>(q, k, v, o, batch, heads, n, s, st);
}
