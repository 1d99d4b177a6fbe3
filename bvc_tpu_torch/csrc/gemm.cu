// Tiled GEMM for Hopper (sm_90a) on the tensor cores: C = A B^T with A
// [M, K] and B [N, K], both K-contiguous (B in the nn.Linear weight layout),
// int8 x int8 -> int32 and bf16 x bf16 -> f32.
//
// Replaces tools/probe_pallas_int8.py::kern_i8 (int8 x int8 -> int32,
// exact) and ::kern_bf16 (bf16 x bf16 -> f32), both launched from main()
// there, ungridded at 1024^3 and gridded over 512-row blocks at
// [8192, 1024] x [1024, 1024].  The probe's B is [K, N]; here it is [N, K],
// the row.col operand pair that mma.sync takes.  The s8 instantiation also
// computes the int8 product inside bvc_tpu/ops/quant.py::qdense (an XLA
// dot_general there) on the W8A8 extraction path, with qdense's tail as its
// epilogue:
//   out[t, j] = (float(acc[t, j]) * xscale[t]) * wscale[j] (+ bias[j])
// in f32, each step rounded on its own (__fmul_rn / __fadd_rn keep nvcc
// from contracting it into an FMA that rounds differently from the plain
// version), written as bf16 or f32; so the int32 product never reaches
// device memory on that path.  The raw epilogue writes the accumulator.
//
// Bound.  The path's qkv product for 64 clips ([100352, 768] x [2304, 768],
// bf16 out): 2MKN = 3.55e11 int8 operations take 0.180 ms at 1979 TOPS,
// against 541 MB of A, W and output at 3.35 TB/s, 0.162 ms: bound by
// operations, narrowly; fc1 (N = 3072) likewise.  The probe's raw int8
// [8192, 1024] x [1024, 1024] is bound by its 43 MB of inputs and int32
// output (0.0128 ms), its bf16 twin by operations (0.0174 ms).
//
// Design.  One CTA of 8 warps per 128 x 128 output tile, each warp a
// 64 x 32 sub-tile (4 x 4 mma tiles).  K streams in stages of 128 bytes
// per row (128 int8 or 64 bf16), double-buffered in dynamic shared memory
// with cp.async; shared rows are padded to 144 bytes, so the 8 rows of an
// ldmatrix phase fall on all 32 banks.  Both operands load with
// non-transposed ldmatrix.x4: m16n8k32 s8 and m16n8k16 bf16 place the same
// bytes in the same registers (a 16-row x 32-byte slab of A, two 8-row x
// 32-byte slabs of B), so one k-step of 32 bytes is the same data movement
// for both types and only the mma instruction differs.  Tails: rows of A
// past M, rows of B past N and 16-byte chunks past K are zero-filled on
// load, and stores are masked; K must be a multiple of 16 elements, which
// the entry points check.  wgmma, TMA and a persistent schedule are left
// for later work.
//
// The library has a plain C interface, loaded with ctypes: pointers and the
// stream are passed as void*, sizes and row strides (in elements) as long
// long.  Every row must start on a 16-byte boundary, which the Python
// wrapper ensures; C is a fresh contiguous [M, N] tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using flash::cp_async_16;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::smem_addr;
typedef __nv_bfloat16 bf16;

constexpr int kBlockM = 128;  // rows of A (and of C) per CTA
constexpr int kBlockN = 128;  // rows of B (columns of C) per CTA
constexpr int kStageK = 128;  // bytes of K per stage and row
constexpr int kRowBytes = kStageK + 16;  // padded shared row
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kThreads = kWarpsM * kWarpsN * 32;
constexpr int kMTiles = kBlockM / kWarpsM / 16;  // m16 tiles per warp: 4
constexpr int kNTiles = kBlockN / kWarpsN / 8;   // n8 tiles per warp: 4
constexpr int kTileBytes = kBlockM * kRowBytes;  // one operand, one stage
static_assert(kBlockM == kBlockN, "A and B tiles share one size");
constexpr int kSmemBytes = 4 * kTileBytes;  // A and B, two stages: 73,728 bytes

enum Epilogue { kRaw = 0, kDequantBf16 = 1, kDequantF32 = 2 };

// Four 8 x 8 b16 matrices (8 rows of 16 bytes each), not transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const unsigned char* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// D += A (16 x 32, row-major) * B (32 x 8, column-major), s8 in, s32 accumulate.
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A (16 x 16, row-major) * B (16 x 8, column-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  flash::mma_16816(d, a, b0, b1);
}

// Rows [row0, row0 + 128) and bytes [kb0, kb0 + 128) of a K-contiguous
// operand into a padded shared tile; rows at or beyond `rows` and 16-byte
// chunks at or beyond `kbytes` are zero-filled.  8 threads cover a row.
__device__ __forceinline__ void load_tile(unsigned char* dst, const unsigned char* src,
                                          long long row0, long long rows, long long kb0,
                                          long long kbytes, long long ld_bytes) {
  constexpr int kChunks = kStageK / 16;
#pragma unroll
  for (int it = 0; it < kBlockM * kChunks / kThreads; ++it) {
    // unsigned, so that / and % by the power of two are a shift and a mask
    const unsigned i = threadIdx.x + it * kThreads;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 16;
    const long long row = row0 + r;
    const long long kb = kb0 + c;
    const bool valid = row < rows && kb < kbytes;
    cp_async_16(dst + r * kRowBytes + c, src + (valid ? row * ld_bytes + kb : 0), valid);
  }
}

// Two neighbouring entries of a C row: one 8-byte (int, float) or 4-byte
// (bf16) store where both exist and the pair is aligned, else one by one.
__device__ __forceinline__ void store2(int* p, int v0, int v1, bool both, bool vec) {
  if (both && vec) {
    *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
  } else {
    p[0] = v0;
    if (both) p[1] = v1;
  }
}

__device__ __forceinline__ void store2(float* p, float v0, float v1, bool both, bool vec) {
  if (both && vec) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (both) p[1] = v1;
  }
}

__device__ __forceinline__ void store2(bf16* p, float v0, float v1, bool both, bool vec) {
  if (both && vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16_rn(v0);
    if (both) p[1] = __float2bfloat16_rn(v1);
  }
}

// qdense's tail for one entry, in the plain version's order of roundings.
__device__ __forceinline__ float dequant(int acc, float xs, float ws,
                                         const float* __restrict__ bias, long long col) {
  const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
  return bias != nullptr ? __fadd_rn(v, bias[col]) : v;
}

// Acc: int (s8 operands) or float (bf16 operands).  kEpi: an Epilogue;
// the dequantizing ones exist for s8 only.
template <typename Acc, int kEpi>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const unsigned char* __restrict__ a, const unsigned char* __restrict__ b,
            const float* __restrict__ xscale, const float* __restrict__ wscale,
            const float* __restrict__ bias, void* __restrict__ c, long long m, long long n,
            long long kbytes, long long lda_bytes, long long ldb_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  // stage s: A at smem + s * kTileBytes, B at smem + (2 + s) * kTileBytes

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const long long m0 = static_cast<long long>(blockIdx.y) * kBlockM;
  const long long n0 = static_cast<long long>(blockIdx.x) * kBlockN;

  load_tile(smem, a, m0, m, 0, kbytes, lda_bytes);
  load_tile(smem + 2 * kTileBytes, b, n0, n, 0, kbytes, ldb_bytes);
  cp_async_commit();

  Acc acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
    }
  }

  // This lane's ldmatrix row and 16-byte half of a 32-byte k-step.  A:
  // lanes 0-15 give rows 0-15 of the low half, lanes 16-31 the high half
  // (registers a0..a3).  B: lanes 0-7 rows 0-7 low, 8-15 rows 0-7 high,
  // 16-23 rows 8-15 low, 24-31 rows 8-15 high (b0, b1 of two n-tiles).
  const int a_off = (wm * 16 * kMTiles + (lane & 15)) * kRowBytes + (lane >> 4) * 16;
  const int b_off = (wn * 8 * kNTiles + (lane & 7) + ((lane >> 4) << 3)) * kRowBytes +
                    ((lane >> 3) & 1) * 16;

  const int num_k = static_cast<int>((kbytes + kStageK - 1) / kStageK);
  for (int kt = 0; kt < num_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < num_k) {
      const long long kb = static_cast<long long>(kt + 1) * kStageK;
      load_tile(smem + (buf ^ 1) * kTileBytes, a, m0, m, kb, kbytes, lda_bytes);
      load_tile(smem + (2 + (buf ^ 1)) * kTileBytes, b, n0, n, kb, kbytes, ldb_bytes);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the stage just requested has landed
    __syncthreads();

    const unsigned char* ta = smem + buf * kTileBytes + a_off;
    const unsigned char* tb = smem + (2 + buf) * kTileBytes + b_off;
#pragma unroll
    for (int ks = 0; ks < kStageK / 32; ++ks) {
      uint32_t af[kMTiles][4];
      uint32_t bfr[kNTiles][2];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) ldmatrix_x4(af[mt], ta + mt * 16 * kRowBytes + ks * 32);
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, tb + np * 16 * kRowBytes + ks * 32);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) mma(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
      }
    }
    __syncthreads();  // the next iteration refills the other stage
  }

  // Accumulator layout: thread (g, t) holds rows g and g + 8 of each m16
  // tile, columns 2t and 2t + 1 of each n8 tile.
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool even_n = (n & 1) == 0;  // pairs start on even columns: vector stores
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + wm * 16 * kMTiles + mt * 16 + g + 8 * half;
      if (row >= m) continue;
      float xs = 0.f;
      if constexpr (kEpi != kRaw) xs = xscale[row];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const long long col = n0 + wn * 8 * kNTiles + nt * 8 + 2 * t;
        if (col >= n) continue;
        const bool both = col + 1 < n;
        const Acc v0 = acc[mt][nt][2 * half];
        const Acc v1 = acc[mt][nt][2 * half + 1];
        if constexpr (kEpi == kRaw) {
          store2(static_cast<Acc*>(c) + row * n + col, v0, v1, both, even_n);
        } else {
          const float o0 = dequant(v0, xs, wscale[col], bias, col);
          const float o1 = both ? dequant(v1, xs, wscale[col + 1], bias, col + 1) : 0.f;
          using Out = std::conditional_t<kEpi == kDequantBf16, bf16, float>;
          store2(static_cast<Out*>(c) + row * n + col, o0, o1, both, even_n);
        }
      }
    }
  }
}

template <typename Acc, int kEpi>
cudaError_t launch(const void* a, const void* b, const void* xscale, const void* wscale,
                   const void* bias, void* c, long long m, long long n, long long kbytes,
                   long long lda_bytes, long long ldb_bytes, cudaStream_t stream) {
  const auto kernel = gemm_kernel<Acc, kEpi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((n + kBlockN - 1) / kBlockN),
                  static_cast<unsigned>((m + kBlockM - 1) / kBlockM));
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const unsigned char*>(a), static_cast<const unsigned char*>(b),
      static_cast<const float*>(xscale), static_cast<const float*>(wscale),
      static_cast<const float*>(bias), c, m, n, kbytes, lda_bytes, ldb_bytes);
  return cudaGetLastError();
}

// Sizes the kernels take: M and N at least 1, M within the grid's y range,
// K a non-negative multiple of 16 elements.
bool shape_ok(long long m, long long n, long long k) {
  return m > 0 && n > 0 && k >= 0 && k % 16 == 0 && (m + kBlockM - 1) / kBlockM <= 65535;
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
  cudaError_t err = cudaErrorInvalidValue;
  if (!shape_ok(m, n, k)) return static_cast<int>(err);
  if (out_kind == kRaw) {
    err = launch<int, kRaw>(a, b, nullptr, nullptr, nullptr, c, m, n, k, lda, ldb, st);
  } else if (out_kind == kDequantBf16 && xscale != nullptr && wscale != nullptr) {
    err = launch<int, kDequantBf16>(a, b, xscale, wscale, bias, c, m, n, k, lda, ldb, st);
  } else if (out_kind == kDequantF32 && xscale != nullptr && wscale != nullptr) {
    err = launch<int, kDequantF32>(a, b, xscale, wscale, bias, c, m, n, k, lda, ldb, st);
  }
  return static_cast<int>(err);
}

// bf16 A [M, K] (row stride lda) times bf16 B [N, K] (row stride ldb) into
// f32 C [M, N].
extern "C" int bvc_gemm_bf16(const void* a, const void* b, void* c, long long m, long long n,
                             long long k, long long lda, long long ldb, void* stream) {
  if (!shape_ok(m, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<float, kRaw>(a, b, nullptr, nullptr, nullptr, c, m, n, 2 * k,
                                              2 * lda, 2 * ldb, static_cast<cudaStream_t>(stream)));
}
