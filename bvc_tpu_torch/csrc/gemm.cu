// GEMM for Hopper (sm_90a) on the tensor cores: C = A B^T with A [M, K]
// and B [N, K], both K-contiguous (B in the nn.Linear weight layout),
// int8 x int8 -> int32 and bf16 x bf16 -> f32.
//
// Replaces tools/probe_pallas_int8.py::kern_i8 (int8 x int8 -> int32,
// exact) and ::kern_bf16 (bf16 x bf16 -> f32), both launched from main()
// there, ungridded at 1024^3 and gridded over 512-row blocks at
// [8192, 1024] x [1024, 1024].  The probe's B is [K, N]; here it is [N, K].
// The s8 instantiation also computes the int8 product inside
// bvc_tpu/ops/quant.py::qdense (an XLA dot_general there) on the W8A8
// extraction path, with qdense's tail as its epilogue:
//   out[t, j] = (float(acc[t, j]) * xscale[t]) * wscale[j] (+ bias[j])
// in f32, each step rounded on its own (__fmul_rn / __fadd_rn keep nvcc
// from contracting it into an FMA that rounds differently from the plain
// version), written as bf16 or f32; so the int32 product never reaches
// device memory on that path.  The raw epilogue writes the accumulator.
//
// Bound.  The path's qkv product for 64 clips ([100352, 768] x [2304, 768],
// bf16 out): 2MKN = 3.55e11 int8 operations take 0.180 ms at 1979 TOPS,
// against 541 MB of A, W and output at 3.35 TB/s, 0.162 ms: bound by
// operations, narrowly; fc1 (N = 3072) 0.239 ms by operations against
// 0.208 ms of bytes.  The output is most of the bytes (462 of qkv's 541
// MB), so its store has to overlap the products.  The probe's raw int8
// [8192, 1024] x [1024, 1024] is bound by its 43 MB of inputs and int32
// output (0.0128 ms), its bf16 twin by operations (0.0174 ms).
//
// Design: a persistent, warp-specialised kernel, one CTA of three
// warpgroups per SM.
// - Warpgroup 0 is the producer: one thread walks the CTA's output tiles
//   and streams K through a ring of kStages stages with TMA, each stage a
//   128-row x 128-byte box of A and one of B (128 int8 or 64 bf16 of K),
//   128-byte swizzled into 1024-byte aligned buffers.  A full and an empty
//   mbarrier per stage hand it to the consumers and back.  Rows past M or N
//   and bytes past K arrive as zeros (TMA's out-of-bounds fill), so K needs
//   only to be a multiple of 16 elements (the row pitch TMA takes).
// - Warpgroups 1 and 2 are consumers and take the CTA's tiles in turns
//   (ping-pong): each computes a whole 128 x 128 tile with wgmma
//   (m64n128k32 s8 -> s32 or m64n128k16 bf16 -> f32, both operands read
//   from shared memory through descriptors, two m64 halves per 32-byte
//   k-step) and then runs its epilogue while the other one multiplies.  A
//   stage is released once the wgmma group that read it has retired (one
//   group stays in flight).  The two mainloops take turns through a pair of
//   mbarriers, which keeps every wait on a stage's barrier within one phase
//   of it.  setmaxnreg gives the consumers 232 registers and leaves the
//   producer 40.
// - Tiles are numbered N-fastest within a 128-row panel of C, and CTA i
//   takes tiles i, i + grid, ...: the CTAs at work at any moment cover a
//   few panels, so each panel of A is read from device memory about once
//   and B (the weight, 1.8-2.4 MB on the path) stays in L2.
// - Epilogue: the dequant's scales are loaded before the mainloop; each
//   warp converts its accumulators to C's type in registers and stages its
//   16 rows of a half tile in shared memory, in 128-byte swizzled boxes.
//   Where C's row pitch is a multiple of 16 bytes (every shape of the path),
//   one lane hands the boxes to TMA tensor stores, which clip them at the M
//   and N edges and write them while the warp goes on; elsewhere (bf16 at
//   N = 2300, for one) the lanes write the rows back in 16-byte pieces,
//   masked at the edges.
//
// The library has a plain C interface, loaded with ctypes: pointers and the
// stream are passed as void*, sizes and row strides (in elements) as long
// long.  Every row of A and B must start on a 16-byte boundary (TMA's
// rule), which the Python wrapper ensures; C is a fresh contiguous [M, N]
// tensor.  The tensor maps are encoded on the host for each call through
// libcuda's cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint,
// so the library does not link libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_common.cuh"

namespace {

using hopper::mbar_arrive_if;
using hopper::mbar_wait;
typedef __nv_bfloat16 bf16;

constexpr int kBlockM = 128;   // rows of A (and of C) per tile
constexpr int kBlockN = 128;   // rows of B (columns of C) per tile
constexpr int kStageK = 128;   // bytes of K per stage and row: one swizzle span
constexpr int kStages = 5;     // depth of the TMA ring: what shared memory holds beside the staging
constexpr int kConsumers = 2;  // consumer warpgroups, taking tiles in turns
constexpr int kThreads = (1 + kConsumers) * 128;
constexpr int kTileBytes = kBlockM * kStageK;  // one operand, one stage: 16 KB
constexpr int kStageBytes = 2 * kTileBytes;
static_assert(kBlockM == kBlockN, "A and B boxes share one tensor-map box size");
// A warp's staging buffer: half tiles of 16 rows x 128 entries of C, each
// cut in 128-byte wide boxes of 16 rows (2 of bf16, 4 of 4-byte entries),
// 128-byte swizzled as the C tensor map reads them: 16-byte chunk k of row
// r sits at chunk k ^ (r % 8), which also spreads the accumulator pairs of
// the rows of a warp over all 32 banks.  Two bf16 half tiles fit, or one of
// 4-byte entries.
constexpr int kBoxBytes = 16 * 128;
constexpr int kStagingBytes = 16 * kBlockN * 4;
constexpr int kSmemBytes = 1024 /* alignment slack */ + kStages * kStageBytes +
                           kConsumers * 4 * kStagingBytes + (2 * kStages + kConsumers) * 8;

enum Epilogue { kRaw = 0, kDequantBf16 = 1, kDequantF32 = 2 };

// C's entry type: the accumulator for the raw epilogue, else bf16 or f32.
template <typename Acc, int kEpi>
using OutOf = std::conditional_t<kEpi == kDequantBf16, bf16,
                                 std::conditional_t<kEpi == kDequantF32, float, Acc>>;

// Byte offset, in a swizzled staging half tile, of the entry (row, col).
template <typename Out>
__device__ __forceinline__ int staged(int row, int col) {
  const int byte = col * static_cast<int>(sizeof(Out));
  return byte / 128 * kBoxBytes + row * 128 + ((byte / 16 % 8) ^ (row % 8)) * 16 + byte % 16;
}

__device__ __forceinline__ void mma(int (&d)[64], uint64_t a, uint64_t b) {
  hopper::wgmma_m64n128k32(d, a, b);
}

__device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
  hopper::wgmma_m64n128k16(d, a, b);
}

// qdense's tail for one entry, in the plain version's order of roundings.
__device__ __forceinline__ float dequant(int acc, float xs, float ws, float b, bool has_bias) {
  const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
  return has_bias ? __fadd_rn(v, b) : v;
}

// 16 bytes of a C row (w) at p, of which the first `valid` bytes lie inside
// the row: one 16-byte store where the address allows, else two 8-byte
// ones, else entry by entry (kElem bytes each).
template <int kElem>
__device__ __forceinline__ void store16(unsigned char* p, const uint32_t (&w)[4], int valid) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  if (valid >= 16 && (addr & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if (valid >= 16 && (addr & 7) == 0) {
    reinterpret_cast<uint2*>(p)[0] = make_uint2(w[0], w[1]);
    reinterpret_cast<uint2*>(p)[1] = make_uint2(w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 16 / kElem; ++e) {
      if (e * kElem >= valid) break;
      if constexpr (kElem == 4) {
        reinterpret_cast<uint32_t*>(p)[e] = w[e];
      } else {
        reinterpret_cast<uint16_t*>(p)[e] = static_cast<uint16_t>(w[e / 2] >> (16 * (e % 2)));
      }
    }
  }
}

// Acc: int (s8 operands) or float (bf16 operands).  kEpi: an Epilogue;
// the dequantizing ones exist for s8 only.
template <typename Acc, int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const __grid_constant__ CUtensorMap map_c, const float* __restrict__ xscale,
            const float* __restrict__ wscale, const float* __restrict__ bias,
            void* __restrict__ c, int m, int n, int num_k, bool tma_store) {
  using Out = OutOf<Acc, kEpi>;
  constexpr int kElemsPerStage = kStageK / (std::is_same_v<Acc, int> ? 1 : 2);

  extern __shared__ unsigned char smem_raw[];
  // stage s: A at ring + s * kStageBytes, B kTileBytes after it
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* staging = ring + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kConsumers * 4 * kStagingBytes);
  uint64_t* empty = full + kStages;
  uint64_t* turn = empty + kStages;  // turn[w]: the other warpgroup's mainloop has ended

  const int n_tiles = (n + kBlockN - 1) / kBlockN;
  const int tiles = (m + kBlockM - 1) / kBlockM * n_tiles;
  // warp-uniform by construction (a broadcast), so that ptxas sees each
  // role's wgmma on a path that no warp diverges into
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);   // the producer's arrival, plus the TMA bytes
      hopper::mbar_init(&empty[s], 4);  // one arrival per warp of the consuming warpgroup
    }
    for (int w = 0; w < kConsumers; ++w) hopper::mbar_init(&turn[w], 4);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / n_tiles * kBlockM;
        const int n0 = t % n_tiles * kBlockN;
        for (int kb = 0; kb < num_k; ++kb) {
          mbar_wait(&empty[s], phase ^ 1);  // passes at once on the first lap
          hopper::mbar_arrive_expect_tx(&full[s], kStageBytes);
          unsigned char* dst = ring + s * kStageBytes;
          hopper::tma_load_2d(dst, &map_a, kb * kElemsPerStage, m0, &full[s]);
          hopper::tma_load_2d(dst + kTileBytes, &map_b, kb * kElemsPerStage, n0, &full[s]);
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup `cons` takes the CTA's tiles cons, cons + 2, ... ----
    hopper::setmaxnreg_inc<232>();
    const int cons = wg - 1;
    const int warp = __shfl_sync(0xffffffff, (threadIdx.x >> 5) & 3, 0);
    const int lane = threadIdx.x & 31;

    // Epilogue layouts.  Accumulators: thread (g, q) = (lane / 4, lane % 4)
    // holds rows g and g + 8 of the warp's 16 in each m64 half, columns
    // 8 j + 2 q and 8 j + 2 q + 1 (j < 16).  Read-back: each lane takes 16
    // bytes of C (kCols entries) in kPasses rows, kRowStep apart.
    const int g = lane >> 2;
    const int q = lane & 3;
    constexpr int kCols = 16 / sizeof(Out);
    constexpr int kLanesPerRow = kBlockN / kCols;
    constexpr int kRowStep = 32 / kLanesPerRow;
    constexpr int kPasses = 16 / kRowStep;
    const int c_local = lane % kLanesPerRow * kCols;
    const int r_first = lane / kLanesPerRow;
    unsigned char* stage_buf = staging + (cons * 4 + warp) * kStagingBytes;

    uint32_t pos = cons * num_k;  // ring position of this warpgroup's next k-block
    // The two mainloops take turns: a warpgroup waits on a stage's full
    // barrier only once the other one has waited on the stage's previous
    // phase, which the parity of the wait needs.  Warpgroup 0 goes first
    // (its first wait, on parity 1, passes at once).
    uint32_t turn_phase = cons == 0 ? 1 : 0;
    for (int t = blockIdx.x + cons * gridDim.x; t < tiles; t += kConsumers * gridDim.x) {
      const int m0 = t / n_tiles * kBlockM;
      const int n0 = t % n_tiles * kBlockN;

      // the dequant's scales and bias for this thread's accumulators, loaded
      // before the mainloop, which hides their latency: ws[2 j + e] is
      // column n0 + 8 j + 2 q + e, xs[h][e] row m0 + 64 h + 16 warp + g + 8 e
      float ws[32], bs[32], xs[2][2];
      if constexpr (kEpi != kRaw) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = n0 + 8 * (i / 2) + 2 * q + i % 2;
          ws[i] = col < n ? wscale[col] : 0.f;
          bs[i] = bias != nullptr && col < n ? bias[col] : 0.f;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = m0 + 64 * h + 16 * warp + g + 8 * e;
            xs[h][e] = row < m ? xscale[row] : 0.f;
          }
        }
      }

      Acc acc[2][64];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[h][i] = 0;
        hopper::fence_operands(acc[h]);
      }
      int s = pos % kStages;
      uint32_t phase = (pos / kStages) & 1;
      int prev = 0;
      mbar_wait(&turn[cons], turn_phase);
      turn_phase ^= 1;
      for (int kb = 0; kb < num_k; ++kb) {
        mbar_wait(&full[s], phase);
        hopper::wgmma_fence();
        const uint32_t a = hopper::smem_addr(ring + s * kStageBytes);
        const uint32_t b = a + kTileBytes;
#pragma unroll
        for (int ks = 0; ks < kStageK / 32; ++ks) {
          const uint64_t db = hopper::desc_sw128(b + 32 * ks);
          mma(acc[0], hopper::desc_sw128(a + 32 * ks), db);
          mma(acc[1], hopper::desc_sw128(a + 64 * kStageK + 32 * ks), db);
        }
        hopper::wgmma_commit();
        // the previous stage's products have retired: release it (no wait
        // is conditional, so that ptxas sees every read of the accumulators
        // after one)
        hopper::wgmma_wait<1>();
        mbar_arrive_if(&empty[prev], lane == 0 && kb > 0);
        prev = s;
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
      mbar_arrive_if(&turn[1 - cons], lane == 0);
      hopper::wgmma_wait<0>();
      mbar_arrive_if(&empty[prev], lane == 0 && num_k > 0);
      hopper::fence_operands(acc[0]);
      hopper::fence_operands(acc[1]);
      pos += kConsumers * num_k;

      // ---- epilogue, overlapping the other warpgroup's products: each
      // warp converts its 16 rows of a half tile to C's type in registers
      // and stages them.  Where C's row pitch allows a tensor map, lane 0
      // hands the staged boxes to TMA stores, which clip them at the M and N
      // edges and write them while the warp goes on; else the lanes write
      // the rows back in 16-byte pieces.
      constexpr int kHalfBytes = 16 * kBlockN * static_cast<int>(sizeof(Out));
      constexpr int kRegions = kStagingBytes / kHalfBytes;
      const int col = n0 + c_local;
      const int valid = min(n - col, kCols) * static_cast<int>(sizeof(Out));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned char* buf = stage_buf + h % kRegions * kHalfBytes;
        hopper::bulk_wait_read<kRegions - 1>();  // the stores that last read buf
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          struct alignas(2 * sizeof(Out)) Pair { Out x, y; };
          Pair lo, hi;  // rows g and g + 8
          if constexpr (kEpi == kRaw) {
            lo = Pair{acc[h][4 * j], acc[h][4 * j + 1]};
            hi = Pair{acc[h][4 * j + 2], acc[h][4 * j + 3]};
          } else {
            const bool b = bias != nullptr;
            const float o0 = dequant(acc[h][4 * j], xs[h][0], ws[2 * j], bs[2 * j], b);
            const float o1 = dequant(acc[h][4 * j + 1], xs[h][0], ws[2 * j + 1], bs[2 * j + 1], b);
            const float o2 = dequant(acc[h][4 * j + 2], xs[h][1], ws[2 * j], bs[2 * j], b);
            const float o3 = dequant(acc[h][4 * j + 3], xs[h][1], ws[2 * j + 1], bs[2 * j + 1], b);
            if constexpr (kEpi == kDequantBf16) {
              lo = Pair{__float2bfloat16_rn(o0), __float2bfloat16_rn(o1)};
              hi = Pair{__float2bfloat16_rn(o2), __float2bfloat16_rn(o3)};
            } else {
              lo = Pair{o0, o1};
              hi = Pair{o2, o3};
            }
          }
          *reinterpret_cast<Pair*>(buf + staged<Out>(g, 8 * j + 2 * q)) = lo;
          *reinterpret_cast<Pair*>(buf + staged<Out>(g + 8, 8 * j + 2 * q)) = hi;
        }
        const int row0 = m0 + 64 * h + 16 * warp;
        if (tma_store) {
          hopper::fence_proxy_async();
          __syncwarp();
#pragma unroll
          for (int box = 0; box < kHalfBytes / kBoxBytes; ++box) {
            hopper::tma_store_2d_if(&map_c, buf + box * kBoxBytes,
                                    n0 + box * 128 / static_cast<int>(sizeof(Out)), row0,
                                    lane == 0);
          }
          hopper::bulk_commit();
        } else {
          __syncwarp();
#pragma unroll
          for (int i = 0; i < kPasses; ++i) {
            const int r = r_first + i * kRowStep;
            const int row = row0 + r;
            if (row >= m || col >= n) continue;
            const uint4 u = *reinterpret_cast<const uint4*>(buf + staged<Out>(r, c_local));
            const uint32_t w[4] = {u.x, u.y, u.z, u.w};
            Out* dst = static_cast<Out*>(c) + static_cast<long long>(row) * n + col;
            store16<sizeof(Out)>(reinterpret_cast<unsigned char*>(dst), w, valid);
          }
        }
      }
    }
    hopper::bulk_wait_all();  // the stores read shared memory that lives as long as the CTA
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once; null where libcuda has
// none.
EncodeTiled encode_tiled() {
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

// The tensor map of a K-contiguous operand [rows, k] (row pitch ld_bytes,
// elem_bytes an entry), cut in boxes of kBlockM rows x kStageK bytes,
// 128-byte swizzled, zero-filled out of bounds.
CUresult encode_operand(EncodeTiled encode, CUtensorMap* map, const void* base, long long rows,
                        long long k, long long ld_bytes, int elem_bytes) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kStageK / elem_bytes), kBlockM};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The tensor map of C [rows, cols] (row pitch cols entries), cut in boxes
// of 16 rows x 128 bytes, 128-byte swizzled, as the epilogue stages them.
CUresult encode_output(EncodeTiled encode, CUtensorMap* map, void* base, long long rows,
                       long long cols, int elem_bytes, CUtensorMapDataType type) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols * elem_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes), 16};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, base, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Encodes the tensor maps (A and B unless K = 0; C where its row pitch is a
// multiple of 16 bytes) and launches one CTA per SM (fewer when there are
// fewer tiles).  Returns a cudaError_t, or the CUresult of a tensor map
// that cuTensorMapEncodeTiled refused.
template <typename Acc, int kEpi>
int launch(const void* a, const void* b, const void* xscale, const void* wscale,
           const void* bias, void* c, long long m, long long n, long long k, long long lda,
           long long ldb, cudaStream_t stream) {
  using Out = OutOf<Acc, kEpi>;
  constexpr int kElem = std::is_same_v<Acc, int> ? 1 : 2;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_a{}, map_b{}, map_c{};  // a map left zero is not read
  CUresult r = CUDA_SUCCESS;
  if (k > 0) {
    r = encode_operand(encode, &map_a, a, m, k, lda * kElem, kElem);
    if (r == CUDA_SUCCESS) r = encode_operand(encode, &map_b, b, n, k, ldb * kElem, kElem);
  }
  const bool tma_store = n * static_cast<long long>(sizeof(Out)) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(c) % 16 == 0;
  if (r == CUDA_SUCCESS && tma_store) {
    const CUtensorMapDataType type = std::is_same_v<Out, bf16>    ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : std::is_same_v<Out, float> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                                  : CU_TENSOR_MAP_DATA_TYPE_INT32;
    r = encode_output(encode, &map_c, c, m, n, sizeof(Out), type);
  }
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  const auto kernel = gemm_kernel<Acc, kEpi>;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (m + kBlockM - 1) / kBlockM * ((n + kBlockN - 1) / kBlockN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  const int num_k = static_cast<int>((k * kElem + kStageK - 1) / kStageK);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      map_a, map_b, map_c, static_cast<const float*>(xscale), static_cast<const float*>(wscale),
      static_cast<const float*>(bias), c, static_cast<int>(m), static_cast<int>(n), num_k,
      tma_store);
  return static_cast<int>(cudaGetLastError());
}

// Sizes the kernels take: M and N at least 1, K a non-negative multiple of
// 16 elements, and tile counts and ring positions within 32 bits.
bool shape_ok(long long m, long long n, long long k) {
  constexpr long long kLimit = 1ll << 31;
  if (m <= 0 || n <= 0 || k < 0 || k % 16 != 0 || m >= kLimit - kBlockM || n >= kLimit - kBlockN) {
    return false;
  }
  const long long tiles = (m + kBlockM - 1) / kBlockM * ((n + kBlockN - 1) / kBlockN);
  return tiles * (2 * k / kStageK + 1) < kLimit;
}

}  // namespace

// int8 A [M, K] (row stride lda) times int8 B [N, K] (row stride ldb).
// out_kind 0: C is int32 [M, N], the raw product (xscale, wscale and bias
// unused); 1 and 2: C is bf16 or f32 [M, N], dequantized with the f32
// xscale [M], wscale [N] and, unless null, bias [N].  Any other kind or
// size is refused with cudaErrorInvalidValue before anything launches.
extern "C" int bvc_gemm_s8(const void* a, const void* b, const void* xscale,
                           const void* wscale, const void* bias, void* c, long long m,
                           long long n, long long k, long long lda, long long ldb,
                           long long out_kind, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(m, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (out_kind == kRaw) {
    return launch<int, kRaw>(a, b, nullptr, nullptr, nullptr, c, m, n, k, lda, ldb, st);
  }
  if (out_kind == kDequantBf16 && xscale != nullptr && wscale != nullptr) {
    return launch<int, kDequantBf16>(a, b, xscale, wscale, bias, c, m, n, k, lda, ldb, st);
  }
  if (out_kind == kDequantF32 && xscale != nullptr && wscale != nullptr) {
    return launch<int, kDequantF32>(a, b, xscale, wscale, bias, c, m, n, k, lda, ldb, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 A [M, K] (row stride lda) times bf16 B [N, K] (row stride ldb) into
// f32 C [M, N].
extern "C" int bvc_gemm_bf16(const void* a, const void* b, void* c, long long m, long long n,
                             long long k, long long lda, long long ldb, void* stream) {
  if (!shape_ok(m, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float, kRaw>(a, b, nullptr, nullptr, nullptr, c, m, n, k, lda, ldb,
                             static_cast<cudaStream_t>(stream));
}
