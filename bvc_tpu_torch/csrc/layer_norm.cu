// LayerNorm over the last axis of bf16 activations, forward and backward,
// one pass over memory each, with f32 statistics: layer_norm of
// bvc_tpu_torch/models/vit.py (the eager chain, ops/layer_norm.py
// layer_norm_chain).
//
// Replaces no TPU kernel: on the TPU, XLA fuses bvc_tpu/models/vit.py's
// layer_norm and its autodiff into the neighbouring passes.  In eager
// PyTorch the chain is about a dozen kernels forward (the f32 copy, two
// means, the differences, the square, rsqrt, the products and sums, the
// bf16 cast), each reading and writing the whole activation in f32, and
// about twenty autograd nodes backward, which keep about three f32 copies of
// the input.
//
// Arithmetic.  Forward, on a row of width d:
//   mean = sum(x) / d;  var = sum((x - mean)^2) / d;  rstd = 1 / sqrt(var + eps)
//   y = (x - mean) * rstd;  y = y * w + b  (with an affine)
// x - mean, the products and the sum of y each rounded on its own in f32
// (__fsub_rn / __fmul_rn / __fadd_rn keep nvcc from contracting a multiply
// and an add into an FMA), in the chain's order, then y rounded to bf16
// once (to nearest even, as PyTorch's cast on the card).  PyTorch's mean
// sums in an order of its own, so the statistics cannot be the chain's bit
// for bit; here the eight elements of a 16-byte piece are summed pairwise in
// f32, the pieces and the lanes of the row in f64, and mean is the f64 sum
// over d rounded to f32; var sums the f32 squares of the f32 x - mean the
// same way, and rstd = 1 / sqrt(var + eps) is taken in f64 and rounded to
// f32.  mean and rstd so sit at least as close to f64 statistics as the
// chain's, and y differs from the chain's only where their last bits move a
// value across a bf16 rounding boundary, by one bf16 ulp.
//
// Backward, with xhat = (x - mean) * rstd as in the forward and g = dy * w
// (g = dy for the unit affine):
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat))
// in f32, the two row sums taken as the forward's, dx rounded to bf16 once;
// dweight = the sum over rows of dy * xhat and dbias = the sum of dy, in f32.
// No atomics: each CTA keeps its rows' column sums in registers, adds its
// row groups' in shared memory in a fixed order and writes one [2, d] row of
// a scratch buffer; a second kernel adds the CTAs' rows column by column in
// a fixed order.  So dweight and dbias repeat bit for bit from run to run on
// one card (the CTA count follows the card's SM count).
//
// Bound.  Bytes, far below the card's ridge point: the forward at
// extraction's [64, 1568, 768] reads 154 MB and writes 154 MB (0.092 ms at
// 3.35 TB/s) for about ten f32 operations an element; the backward reads x
// and dy and writes dx (0.138 ms there).
//
// Design: a row goes to a group of wpr warps (1, 2, 4 or 8: the fewest whose
// lanes hold the row in at most kMaxPieces 16-byte pieces each), and each
// lane keeps its pieces in registers from the load to the store: piece p of
// the row belongs to lane p mod (32 wpr) of the group, so neighbouring lanes
// read neighbouring 16 bytes.  Both choices follow from d alone.  A CTA has
// 256 threads and 8 / wpr rows at a time.  Row sums go through a butterfly
// of warp shuffles, which leaves the same sum in every lane, and through
// shared memory across a group's warps.  The forward gives each CTA one set
// of rows; the backward's grid is at most max_ctas CTAs (the wrapper passes
// twice the SM count), which walk the rows in turn.  Widths: multiples of 8
// up to kMaxWidth = 8192 (8 warps x 32 lanes x 4 pieces x 8).
//
// The library has a plain C interface, loaded with ctypes: pointers and the
// stream are passed as void*, counts as long long, eps as double.  x, dy, y
// and dx are contiguous bf16 [rows, d] starting on 16 bytes; w and b f32
// [d] on 16 bytes, or both null (the unit affine); mean and rstd f32 [rows];
// partial f32 [max_ctas, 2, d].  The wrapper ensures it.  Each entry point
// launches on the given stream, allocates nothing, does not synchronise,
// launches nothing for rows = 0, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;         // bf16 in one 16-byte piece
constexpr int kMaxPieces = 4;   // 16-byte pieces of a row a lane holds at most
constexpr int kMaxWidth = kWarps * 32 * kMaxPieces * kVec;  // 8192

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// The two bf16 of a 32-bit word as f32 (exact), element 0 in the low half.
__device__ __forceinline__ float low(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float high(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[kVec]) {
  f[0] = low(v.x);
  f[1] = high(v.x);
  f[2] = low(v.y);
  f[3] = high(v.y);
  f[4] = low(v.z);
  f[5] = high(v.z);
  f[6] = low(v.w);
  f[7] = high(v.w);
}

// Two f32 rounded to bf16 (to nearest even) in one word, a in the low half.
__device__ __forceinline__ uint32_t pack(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(a)))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(b))) << 16);
}

__device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
  return make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]), pack(f[6], f[7]));
}

__device__ __forceinline__ float pairwise(const float (&f)[kVec]) {
  return add(add(add(f[0], f[1]), add(f[2], f[3])), add(add(f[4], f[5]), add(f[6], f[7])));
}

// The eight f32 of a [d] vector at piece p.
__device__ __forceinline__ void load8(const float* __restrict__ v, int p, float (&f)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(v) + 2 * p);
  const float4 b = __ldg(reinterpret_cast<const float4*>(v) + 2 * p + 1);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = a.z;
  f[3] = a.w;
  f[4] = b.x;
  f[5] = b.y;
  f[6] = b.z;
  f[7] = b.w;
}

// The sum of v over the lanes of a row group of wpr warps, the same in
// every lane: a butterfly over the warp (lanes i and i^m add the same two
// numbers), then the group's warps in order through shared memory.  Every
// thread of the CTA calls it the same number of times: with wpr > 1 it
// synchronises the CTA.
__device__ __forceinline__ double group_sum(double v, int wpr, double* red) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  if (wpr == 1) return v;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  const int first = warp - warp % wpr;
  double s = red[first];
  for (int i = 1; i < wpr; ++i) s += red[first + i];
  __syncthreads();
  return s;
}

template <int kPieces, bool kAffine>
__global__ void __launch_bounds__(kThreads)
    layer_norm_fwd(const bf16* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, bf16* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out, long long rows,
                   int d, int wpr, double eps) {
  __shared__ double red[kWarps];
  const int lanes = 32 * wpr;
  const int t = threadIdx.x % lanes;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / lanes) + threadIdx.x / lanes;
  const bool live = row < rows;
  const int pieces = d / kVec;
  const uint4* xr = reinterpret_cast<const uint4*>(x) + (live ? row : 0) * pieces;
  uint4 in[kPieces];
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    const int p = t + i * lanes;
    in[i] = (live && p < pieces) ? xr[p] : make_uint4(0u, 0u, 0u, 0u);
  }
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    if (t + i * lanes < pieces) {
      float f[kVec];
      unpack(in[i], f);
      s += pairwise(f);
    }
  }
  const float mean = static_cast<float>(group_sum(s, wpr, red) / d);
  s = 0.0;
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    if (t + i * lanes < pieces) {
      float f[kVec];
      unpack(in[i], f);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float c = sub(f[k], mean);
        f[k] = mul(c, c);
      }
      s += pairwise(f);
    }
  }
  const double var = group_sum(s, wpr, red) / d;
  const float rstd = static_cast<float>(1.0 / sqrt(var + eps));
  if (!live) return;
  if (t == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
  uint4* yr = reinterpret_cast<uint4*>(y) + row * pieces;
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    const int p = t + i * lanes;
    if (p < pieces) {
      float f[kVec];
      unpack(in[i], f);
#pragma unroll
      for (int k = 0; k < kVec; ++k) f[k] = mul(sub(f[k], mean), rstd);
      if constexpr (kAffine) {
        float wk[kVec], bk[kVec];
        load8(w, p, wk);
        load8(b, p, bk);
#pragma unroll
        for (int k = 0; k < kVec; ++k) f[k] = add(mul(f[k], wk[k]), bk[k]);
      }
      yr[p] = pack(f);
    }
  }
}

template <int kPieces, bool kAffine>
__global__ void __launch_bounds__(kThreads, 2)
    layer_norm_bwd(const bf16* __restrict__ dy, const bf16* __restrict__ x,
                   const float* __restrict__ w, const float* __restrict__ mean,
                   const float* __restrict__ rstd, bf16* __restrict__ dx,
                   float* __restrict__ partial, long long rows, int d, int wpr) {
  __shared__ double red[kWarps];
  // each row group's column sums, [groups, d]: groups * d <= kMaxWidth
  __shared__ float cols[kAffine ? kMaxWidth : 1];
  const int lanes = 32 * wpr;
  const int t = threadIdx.x % lanes;
  const int group = threadIdx.x / lanes;
  const int groups = kThreads / lanes;
  const int pieces = d / kVec;
  constexpr int kCols = kAffine ? kPieces * kVec : 1;
  float dw[kCols], db[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) dw[j] = db[j] = 0.0f;

  for (long long first = static_cast<long long>(blockIdx.x) * groups; first < rows;
       first += static_cast<long long>(gridDim.x) * groups) {
    const long long row = first + group;
    const bool live = row < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x) + (live ? row : 0) * pieces;
    const uint4* gr = reinterpret_cast<const uint4*>(dy) + (live ? row : 0) * pieces;
    uint4 xin[kPieces], gin[kPieces];
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int p = t + i * lanes;
      const bool here = live && p < pieces;
      xin[i] = here ? xr[p] : make_uint4(0u, 0u, 0u, 0u);
      gin[i] = here ? gr[p] : make_uint4(0u, 0u, 0u, 0u);
    }
    const float m = live ? mean[row] : 0.0f;
    const float r = live ? rstd[row] : 0.0f;
    double sg = 0.0, sgx = 0.0;
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int p = t + i * lanes;
      if (p < pieces) {
        float xf[kVec], gf[kVec], g[kVec], gx[kVec], wk[kVec];
        unpack(xin[i], xf);
        unpack(gin[i], gf);
        if constexpr (kAffine) load8(w, p, wk);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float xh = mul(sub(xf[k], m), r);
          g[k] = gf[k];
          if constexpr (kAffine) g[k] = mul(gf[k], wk[k]);
          gx[k] = mul(g[k], xh);
          if constexpr (kAffine) {
            dw[i * kVec + k] = fmaf(gf[k], xh, dw[i * kVec + k]);
            db[i * kVec + k] = add(db[i * kVec + k], gf[k]);
          }
        }
        sg += pairwise(g);
        sgx += pairwise(gx);
      }
    }
    const float mg = static_cast<float>(group_sum(sg, wpr, red) / d);
    const float mgx = static_cast<float>(group_sum(sgx, wpr, red) / d);
    if (!live) continue;
    uint4* dxr = reinterpret_cast<uint4*>(dx) + row * pieces;
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int p = t + i * lanes;
      if (p < pieces) {
        float xf[kVec], gf[kVec], wk[kVec];
        unpack(xin[i], xf);
        unpack(gin[i], gf);
        if constexpr (kAffine) load8(w, p, wk);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float xh = mul(sub(xf[k], m), r);
          float g = gf[k];
          if constexpr (kAffine) g = mul(gf[k], wk[k]);
          xf[k] = mul(r, sub(sub(g, mg), mul(xh, mgx)));
        }
        dxr[p] = pack(xf);
      }
    }
  }

  if constexpr (kAffine) {
    // the groups' column sums added in group order: dweight's, then dbias's
#pragma unroll
    for (int which = 0; which < 2; ++which) {
#pragma unroll
      for (int i = 0; i < kPieces; ++i) {
        const int p = t + i * lanes;
        if (p < pieces) {
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            cols[group * d + p * kVec + k] = which == 0 ? dw[i * kVec + k] : db[i * kVec + k];
          }
        }
      }
      __syncthreads();
      float* out = partial + (static_cast<long long>(blockIdx.x) * 2 + which) * d;
      for (int c = threadIdx.x; c < d; c += kThreads) {
        float s = cols[c];
        for (int g = 1; g < groups; ++g) s = add(s, cols[g * d + c]);
        out[c] = s;
      }
      __syncthreads();
    }
  }
}

// dweight and dbias: the n_ctas rows of partial added column by column, a
// CTA a tile of 32 columns (blockIdx.y: 0 dweight, 1 dbias), its warps
// taking every kWarps-th row and then added in warp order.
__global__ void __launch_bounds__(kThreads)
    layer_norm_bwd_sum(const float* __restrict__ partial, float* __restrict__ dw,
                       float* __restrict__ db, int n_ctas, int d) {
  __shared__ float part[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.x * 32 + lane;
  const int which = blockIdx.y;
  float s = 0.0f;
  if (col < d) {
    for (int c = warp; c < n_ctas; c += kWarps) {
      s = add(s, partial[(static_cast<long long>(c) * 2 + which) * d + col]);
    }
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < d) {
    float total = part[0][lane];
    for (int i = 1; i < kWarps; ++i) total = add(total, part[i][lane]);
    (which == 0 ? dw : db)[col] = total;
  }
}

// The launch shape of width d: warps a row (wpr) and 16-byte pieces a lane
// (per_lane); false where the kernels do not take d.
bool launch_shape(long long d, int* wpr, int* per_lane) {
  if (d < kVec || d % kVec != 0 || d > kMaxWidth) return false;
  const int pieces = static_cast<int>(d / kVec);
  *wpr = 1;
  while (pieces > 32 * *wpr * kMaxPieces) *wpr *= 2;
  *per_lane = (pieces + 32 * *wpr - 1) / (32 * *wpr);
  return true;
}

template <bool kAffine>
void launch_fwd(int per_lane, unsigned blocks, cudaStream_t st, const bf16* x, const float* w,
                const float* b, bf16* y, float* mean, float* rstd, long long rows, int d,
                int wpr, double eps) {
  switch (per_lane) {
    case 1:
      layer_norm_fwd<1, kAffine><<<blocks, kThreads, 0, st>>>(x, w, b, y, mean, rstd, rows,
                                                               d, wpr, eps);
      break;
    case 2:
      layer_norm_fwd<2, kAffine><<<blocks, kThreads, 0, st>>>(x, w, b, y, mean, rstd, rows,
                                                               d, wpr, eps);
      break;
    case 3:
      layer_norm_fwd<3, kAffine><<<blocks, kThreads, 0, st>>>(x, w, b, y, mean, rstd, rows,
                                                               d, wpr, eps);
      break;
    default:
      layer_norm_fwd<4, kAffine><<<blocks, kThreads, 0, st>>>(x, w, b, y, mean, rstd, rows,
                                                               d, wpr, eps);
  }
}

template <bool kAffine>
void launch_bwd(int per_lane, unsigned blocks, cudaStream_t st, const bf16* dy, const bf16* x,
                const float* w, const float* mean, const float* rstd, bf16* dx,
                float* partial, long long rows, int d, int wpr) {
  switch (per_lane) {
    case 1:
      layer_norm_bwd<1, kAffine><<<blocks, kThreads, 0, st>>>(dy, x, w, mean, rstd, dx,
                                                               partial, rows, d, wpr);
      break;
    case 2:
      layer_norm_bwd<2, kAffine><<<blocks, kThreads, 0, st>>>(dy, x, w, mean, rstd, dx,
                                                               partial, rows, d, wpr);
      break;
    case 3:
      layer_norm_bwd<3, kAffine><<<blocks, kThreads, 0, st>>>(dy, x, w, mean, rstd, dx,
                                                               partial, rows, d, wpr);
      break;
    default:
      layer_norm_bwd<4, kAffine><<<blocks, kThreads, 0, st>>>(dy, x, w, mean, rstd, dx,
                                                               partial, rows, d, wpr);
  }
}

}  // namespace

// y, mean, rstd = layer_norm(x [rows, d]) with weight w and bias b (both
// null: the unit affine).
extern "C" int bvc_layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                                  void* mean, void* rstd, long long rows, long long d,
                                  double eps, void* stream) {
  int wpr, per_lane;
  if (rows < 0 || !launch_shape(d, &wpr, &per_lane) || (w == nullptr) != (b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const long long per_cta = kWarps / wpr;
  const unsigned blocks = static_cast<unsigned>((rows + per_cta - 1) / per_cta);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  bf16* yp = static_cast<bf16*>(y);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  if (w != nullptr) {
    launch_fwd<true>(per_lane, blocks, st, xp, wp, bp, yp, mp, rp, rows, static_cast<int>(d),
                     wpr, eps);
  } else {
    launch_fwd<false>(per_lane, blocks, st, xp, wp, bp, yp, mp, rp, rows, static_cast<int>(d),
                      wpr, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// dx (and, with w, dweight dw and dbias db) of layer_norm at x for the output
// gradient dy, from the forward's mean and rstd; partial is the scratch of
// at most max_ctas CTAs (unused without w).
extern "C" int bvc_layer_norm_bwd(const void* dy, const void* x, const void* w,
                                  const void* mean, const void* rstd, void* dx, void* partial,
                                  void* dw, void* db, long long rows, long long d,
                                  long long max_ctas, void* stream) {
  int wpr, per_lane;
  if (rows < 0 || max_ctas < 1 || !launch_shape(d, &wpr, &per_lane)
      || (w != nullptr && (partial == nullptr || dw == nullptr || db == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const long long per_cta = kWarps / wpr;
  long long ctas = (rows + per_cta - 1) / per_cta;
  if (ctas > max_ctas) ctas = max_ctas;
  const unsigned blocks = static_cast<unsigned>(ctas);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* dyp = static_cast<const bf16*>(dy);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  bf16* dxp = static_cast<bf16*>(dx);
  float* pp = static_cast<float*>(partial);
  const int di = static_cast<int>(d);
  if (w != nullptr) {
    launch_bwd<true>(per_lane, blocks, st, dyp, xp, wp, mp, rp, dxp, pp, rows, di, wpr);
    const dim3 sum_grid(static_cast<unsigned>((d + 31) / 32), 2);
    layer_norm_bwd_sum<<<sum_grid, kThreads, 0, st>>>(pp, static_cast<float*>(dw),
                                                      static_cast<float*>(db),
                                                      static_cast<int>(ctas), di);
  } else {
    launch_bwd<false>(per_lane, blocks, st, dyp, xp, wp, mp, rp, dxp, pp, rows, di, wpr);
  }
  return static_cast<int>(cudaGetLastError());
}
