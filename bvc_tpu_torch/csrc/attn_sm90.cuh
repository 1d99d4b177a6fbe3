// The Hopper (sm_90a) attention mainloop's pieces, shared by the flash
// forwards (flash_fwd.cu: unmasked, and with a key bias) and the softmax
// probe's forward (softmax_probe.cu): bf16 pre-scaled queries, keys and
// values at head width 64 or 32 (the kernels templated on the width D),
// read through 4-D TMA tensor maps, products on wgmma.  The
// backward (flash_bwd_sm90.cu) takes its tensor maps, helpers and
// accumulator layout from here, with a loop of its own.
//
// Persistent CTAs of a producer and kConsumers consumer warpgroups
// (Cta<kConsumers>), one CTA per SM, each walking query tiles of 64
// kConsumers queries of one (head, batch element): tiles blockIdx.x,
// blockIdx.x + gridDim.x, ..., query tiles fastest (Cta::Work).
// - Warpgroup 0 is the producer: one thread loads each tile's Q once the
//   consumers are done with the last one (q_full / q_empty) and streams
//   128-key K and V tiles through two rings of kStages stages (a full and an
//   empty mbarrier per stage, the empty ones counting one arrival per
//   consumer warp), running ahead into the next query tile.  Key tiles go in
//   reverse order, the ragged last one first, so that the only tile with
//   keys past N is scored while no product is in flight.
// - The other warpgroups are consumers, 64 queries each.  S = Qs K^T is
//   wgmma.m64n128k16 with both operands K-major in shared memory (four
//   k-steps over d = 64, two over d = 32); O += P V is wgmma.m64n64k16
//   (m64n32k16 at d = 32) with P taken from the S registers, rounded to
//   bf16 (the accumulator's layout is the A operand's), and V read MN-major
//   (transposed) from shared memory (eight k-steps over the tile's 128
//   keys).  At d = 32 a row is 64 bytes, and tiles take the 64-byte
//   swizzle (hopper_common.cuh).
// - Overlap within a warpgroup: the S product of tile j and the P V product
//   of tile j - 1 are issued together, and the softmax of tile j runs while
//   P V of tile j - 1 is still on the tensor cores.  Between warpgroups:
//   named barriers hand the right to issue products round the consumers, so
//   that one warpgroup's exponentials run while another's products do.  Every
//   mbarrier wait stays within one phase of its barrier (both consumers
//   take every tile), and no wgmma_wait sits under a condition.
// - Epilogue: each consumer stages its 64 rows of O as bf16 in a buffer of
//   its own (128-byte swizzled, the O map's box), and one thread hands it to
//   a TMA store, which clips the rows past N and runs on while the consumer
//   starts its next query tile.
//
// Tensor maps read a [.., N, .., d] bf16 tensor as 4-D (d, N, h, B) with
// its own element strides, so one map order serves [B, N, h, d] and
// [B, h, N, d]; rows of a box past N (or past a batch element's end) read as
// zeros and are not written.  They are encoded on the host for each call
// through libcuda's cuTensorMapEncodeTiled, found with
// cudaGetDriverEntryPoint, so the libraries do not link libcuda.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace attn {

typedef __nv_bfloat16 bf16;

constexpr int kD = 64;                  // head width: one 128-byte swizzle row of bf16
constexpr int kBlockN = 128;            // keys per streamed tile
constexpr int kStages = 3;              // depth of the K ring and of the V ring
constexpr int kTileBytes = kBlockN * kD * 2;  // a K or V tile: 16 KB
constexpr int kHalfBytes = kTileBytes / 2;    // one consumer's 64 rows of Q, or of O
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Sizes at head width D (64 or 32): a bf16 row is one swizzle row of
// kRowBytes (128 or 64 bytes).
template <int D>
struct Width {
  static_assert(D == 64 || D == 32, "head width 64 or 32");
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kTileBytes = kBlockN * kRowBytes;  // a K or V tile
  static constexpr int kHalfBytes = kTileBytes / 2;       // 64 rows of Q, O, dK or dV
};
// named barriers (0 is __syncthreads): kTurnBar + c lets consumer c issue
// its products; Cta::kStoreBar + c gathers consumer c's staged O tile
constexpr int kTurnBar = 1;

// A position in a ring of kN stages, and the parity of its lap.
template <int kN>
struct StageRing {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == kN) {
      stage = 0;
      phase ^= 1;
    }
  }
};
using Ring = StageRing<kStages>;

__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* full, uint64_t* empty, const Ring& r,
                                          int row, int head, int batch, uint32_t bytes) {
  hopper::mbar_wait(empty, r.phase ^ 1);  // passes at once on the first lap
  hopper::mbar_arrive_expect_tx(full, bytes);
  hopper::tma_load_4d(dst, map, 0, row, head, batch, full);
}

// 2^x on the SFU, flushing results below 2^-126 to 0: exp2f's own
// instruction, without the rescale around it that returns those as
// subnormals (three more instructions a score, for values that add nothing
// to l or to a bf16 P V product).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S [64 x 128] = Q [64 x D] K^T: this consumer's Q rows (q_addr) against a
// K tile, both K-major; the first k-step overwrites S.
template <int D = kD>
__device__ __forceinline__ void issue_s(float (&s)[64], uint32_t q_addr, uint32_t k_addr) {
  constexpr int kRow = Width<D>::kRowBytes;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    hopper::wgmma_m64n128k16(s, hopper::desc_sw<kRow>(q_addr + 32 * ks),
                             hopper::desc_sw<kRow>(k_addr + 32 * ks), ks > 0);
  }
}

// O [64 x D] += P [64 x 128] V [128 x D]: P as bf16 A fragments, p[4 ks ..
// 4 ks + 3] for the keys [16 ks, 16 ks + 16); V MN-major, 16 rows (2048
// bytes at d = 64, 1024 at d = 32) a k-step.
template <int D = kD>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[32],
                                         uint32_t v_addr) {
#pragma unroll
  for (int ks = 0; ks < kBlockN / 16; ++ks) {
    if constexpr (D == 64) {
      hopper::wgmma_m64n64k16_rs(o, p[4 * ks], p[4 * ks + 1], p[4 * ks + 2], p[4 * ks + 3],
                                 hopper::desc_sw128(v_addr + 2048 * ks));
    } else {
      hopper::wgmma_m64n32k16_rs(o, p[4 * ks], p[4 * ks + 1], p[4 * ks + 2], p[4 * ks + 3],
                                 hopper::desc_sw<64>(v_addr + 1024 * ks));
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// P's A fragments from the S accumulator: k-step ks takes the 8-column
// blocks 2 ks and 2 ks + 1, i.e. s[8 ks .. 8 ks + 7] pairwise.
__device__ __forceinline__ void pack_p(uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// Accumulator layout of an m64nN product: thread (g, t) = (lane / 4,
// lane % 4) of warp w holds, in d[4 j + e], row 16 w + g + 8 (e / 2) and
// column 8 j + 2 t + e % 2.  These give an entry's column and its row half.
__device__ __forceinline__ int col_of(int i, int t) { return 8 * (i / 4) + 2 * t + (i & 1); }
__device__ __forceinline__ int half_of(int i) { return (i >> 1) & 1; }

// Entries of an S tile whose column is at or beyond `limit` get `fill`.
__device__ __forceinline__ void mask_cols(float (&s)[64], int limit, int t, float fill) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = col_of(i, t) < limit ? s[i] : fill;
}

// m of each row half: the max with this thread's entries of s, then over
// the four threads that share the row (quad_max alone).
__device__ __forceinline__ void thread_max(const float (&s)[64], float (&m)[2]) {
  float part[2][4];  // four independent chains a row half
#pragma unroll
  for (int i = 0; i < 8; ++i) part[half_of(i)][i / 4 % 2 * 2 + (i & 1)] = s[i];
#pragma unroll
  for (int i = 8; i < 64; ++i) {
    float& x = part[half_of(i)][i / 4 % 2 * 2 + (i & 1)];
    x = fmaxf(x, s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], fmaxf(fmaxf(part[r][0], part[r][1]), fmaxf(part[r][2], part[r][3])));
  }
}

__device__ __forceinline__ void quad_max(float (&m)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
}

__device__ __forceinline__ void row_sum(float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

// ---- host ----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once; null where libcuda has
// none.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// Element strides of a [.., N, .., d] tensor: batch, token, head.
struct Strides {
  long long b, n, h;
};

// The map of a bf16 tensor of `batch` x `n` tokens x `heads` rows of `d`
// (64, or 32), read as (d, N, h, B), in boxes of d x `rows` x 1 x 1, with
// the 128-byte swizzle (the 64-byte one at d = 32), zero-filled out of
// bounds.
inline CUresult encode_map(EncodeTiled encode, CUtensorMap* map, const void* base, long long batch,
                           long long n, long long heads, Strides s, int rows, int d = kD) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.n * 2),
                                 static_cast<cuuint64_t>(s.h * 2),
                                 static_cast<cuuint64_t>(s.b * 2)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(d), static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                d == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Sizes of a CTA of one producer and kConsumers consumer warpgroups, each
// consumer taking 64 of the CTA's kBlockM queries, at head width D, and
// what depends on them.
template <int kConsumers, int D = kD>
struct Cta {
  static constexpr int kBlockM = 64 * kConsumers;
  static constexpr int kThreads = (1 + kConsumers) * 128;
  static constexpr int kRowBytes = Width<D>::kRowBytes;
  static constexpr int kTileBytes = Width<D>::kTileBytes;
  static constexpr int kHalfBytes = Width<D>::kHalfBytes;
  static constexpr int kQBytes = kConsumers * kHalfBytes;
  // setmaxnreg's split of an SM's 64 K registers
  static constexpr int kProducerRegs = kConsumers == 2 ? 40 : 24;
  static constexpr int kConsumerRegs = kConsumers == 2 ? 232 : 160;
  static constexpr int kStoreBar = kTurnBar + kConsumers;
  static constexpr int kLast = kConsumers - 1;  // the consumer that passes the first turn

  struct Smem {  // at a 1024-byte aligned base: every tile on a swizzle atom
    unsigned char q[kQBytes];
    unsigned char k[kStages][kTileBytes];
    unsigned char v[kStages][kTileBytes];
    unsigned char o[kConsumers][kHalfBytes];  // each consumer's O, staged for TMA
    uint64_t q_full, q_empty;
    uint64_t k_full[kStages], k_empty[kStages];
    uint64_t v_full[kStages], v_empty[kStages];
  };
  static constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;  // + alignment slack

  static __device__ __forceinline__ Smem& smem_of(unsigned char* raw) {
    return *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
  }

  // One thread: barriers for the producer's arrivals (full) and one arrival
  // per consumer warp (empty).
  static __device__ __forceinline__ void init_barriers(Smem& sm) {
    hopper::mbar_init(&sm.q_full, 1);
    hopper::mbar_init(&sm.q_empty, 4 * kConsumers);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.k_full[s], 1);
      hopper::mbar_init(&sm.v_full[s], 1);
      hopper::mbar_init(&sm.k_empty[s], 4 * kConsumers);
      hopper::mbar_init(&sm.v_empty[s], 4 * kConsumers);
    }
    hopper::mbar_init_fence();
  }

  // A CTA's work: the query tiles (kBlockM queries of one head and batch
  // element) blockIdx.x, blockIdx.x + gridDim.x, ..., query tiles fastest,
  // so that the CTAs at work at any moment share the K and V of a few heads
  // in L2.
  struct Work {
    int tiles, q_tiles, heads;
    __device__ __forceinline__ int row0(int w) const { return w % q_tiles * kBlockM; }
    __device__ __forceinline__ int head(int w) const { return w / q_tiles % heads; }
    __device__ __forceinline__ int batch(int w) const { return w / q_tiles / heads; }
  };

  static __host__ __device__ __forceinline__ Work work(int n, int heads, int batches) {
    const int q_tiles = (n + kBlockM - 1) / kBlockM;
    return Work{q_tiles * heads * batches, q_tiles, heads};
  }

  // The producer thread: for each of the CTA's query tiles, its Q tile once
  // the consumers are done with the last one, then `k_passes` passes over
  // the K tiles, last tile first, with the V tiles beside the last pass.
  static __device__ __forceinline__ void produce(Smem& sm, const CUtensorMap* map_q,
                                                 const CUtensorMap* map_k,
                                                 const CUtensorMap* map_v, const Work& work,
                                                 int n_tiles, int k_passes) {
    Ring kr, vr;
    uint32_t q_phase = 0;
    for (int w = blockIdx.x; w < work.tiles; w += gridDim.x) {
      const int head = work.head(w);
      const int batch = work.batch(w);
      hopper::mbar_wait(&sm.q_empty, q_phase ^ 1);
      hopper::mbar_arrive_expect_tx(&sm.q_full, kQBytes);
      hopper::tma_load_4d(sm.q, map_q, 0, work.row0(w), head, batch, &sm.q_full);
      q_phase ^= 1;
      for (int pass = 0; pass < k_passes; ++pass) {
        for (int i = 0; i < n_tiles; ++i) {
          const int key0 = (n_tiles - 1 - i) * kBlockN;
          load_tile(sm.k[kr.stage], map_k, &sm.k_full[kr.stage], &sm.k_empty[kr.stage], kr,
                    key0, head, batch, kTileBytes);
          kr.advance();
          if (pass == k_passes - 1) {
            load_tile(sm.v[vr.stage], map_v, &sm.v_full[vr.stage], &sm.v_empty[vr.stage], vr,
                      key0, head, batch, kTileBytes);
            vr.advance();
          }
        }
      }
    }
  }

  // Consumer c waits for its turn to issue products, and hands the turn to
  // the next consumer (where `pred`).  The last consumer passes once before
  // its first product, so consumer 0 goes first, and skips its last pass,
  // which no turn would take.
  static __device__ __forceinline__ void turn_wait(int c) {
    hopper::bar_sync<256>(kTurnBar + c);
  }

  static __device__ __forceinline__ void turn_pass_if(int c, bool pred) {
    hopper::bar_arrive_if<256>(kTurnBar + (c + 1) % kConsumers, pred);
  }

  // Stages this consumer's O [64 x D] (f32 accumulators, already
  // normalised) as bf16 in `stage` (rows of kRowBytes under their swizzle:
  // at 128-byte rows 16-byte chunk k of row r sits at chunk k ^ (r % 8),
  // which also spreads a warp's stores over all banks), then one thread
  // hands it to a TMA store at query row `row`, which clips the rows past N
  // and runs on while the consumer goes on to its next tile.  The staging
  // is rewritten once that thread's previous store has read it.
  static __device__ __forceinline__ void store_o(unsigned char* stage, const float (&o)[D / 2],
                                                 const CUtensorMap* map_o, int row, int head,
                                                 int batch, int c, int warp, int lane) {
    const int g = lane >> 2;
    const int t = lane & 3;
    hopper::bulk_wait_read<0>();
    hopper::bar_sync<128>(kStoreBar + c);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int r = 16 * warp + g + 8 * x;
        unsigned char* at = D == 64 ? stage + r * 128 + ((j ^ g) << 4)  // r % 8 = g
                                    : stage + hopper::swizzle<kRowBytes>(r * kRowBytes + 16 * j);
        *reinterpret_cast<uint32_t*>(at + 4 * t) =
            pack_bf16(o[4 * j + 2 * x], o[4 * j + 2 * x + 1]);
      }
    }
    hopper::fence_proxy_async();
    hopper::bar_sync<128>(kStoreBar + c);
    hopper::tma_store_4d_if(map_o, stage, 0, row, head, batch, warp == 0 && lane == 0);
    hopper::bulk_commit();
  }

  // The four maps of a forward: Q in kBlockM row boxes, K and V in kBlockN
  // ones, O in one consumer's 64-row boxes.  Returns the first refusal.
  static CUresult encode_qkvo(CUtensorMap (&maps)[4], const void* q, const void* k,
                              const void* v, void* o, long long batch, long long n,
                              long long heads, const Strides (&s)[4]) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
    const void* ptrs[4] = {q, k, v, o};
    const int rows[4] = {kBlockM, kBlockN, kBlockN, 64};
    for (int i = 0; i < 4; ++i) {
      const CUresult r = encode_map(encode, &maps[i], ptrs[i], batch, n, heads, s[i], rows[i], D);
      if (r != CUDA_SUCCESS) return r;
    }
    return CUDA_SUCCESS;
  }

  // Sizes the kernels take: at least one token, and query tiles numbered
  // within 32 bits.
  static bool shape_ok(long long batch, long long n, long long heads) {
    return batch > 0 && n > 0 && heads > 0 &&
           (n + kBlockM - 1) / kBlockM * heads * batch < (1ll << 31) - 1024;
  }

  // Lets `kernel` take `smem` bytes of dynamic shared memory (kSmemBytes
  // unless given) and sets `grid` to one CTA per SM, or one per query tile
  // where there are fewer.
  template <typename Kernel>
  static cudaError_t prepare(Kernel kernel, long long batch, long long n, long long heads,
                             int* grid, int smem = kSmemBytes) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    const long long tiles = (n + kBlockM - 1) / kBlockM * heads * batch;
    *grid = static_cast<int>(tiles < sms ? tiles : sms);
    return err;
  }
};

}  // namespace attn
