// The ViT MLP's GELU on bf16 tensors, forward and backward, one pass over
// memory each: the clamped erf polynomial of bvc_tpu_torch/ops/gelu.py
// (gelu_poly), evaluated in f32.
//
// Replaces no TPU kernel: on the TPU, XLA fuses bvc_tpu/ops/gelu.py's
// gelu_poly and its autodiff into the neighbouring passes.  In eager
// PyTorch the same chain is about 20 elementwise kernels forward and 30
// backward, each reading and writing the whole [B, N, 4D] activation in
// f32, and autograd keeps about ten f32 copies of it for the backward.
//
// Arithmetic.  The forward makes the eager chain's operations in its order,
// each rounded on its own (__fmul_rn / __fadd_rn keep nvcc from contracting
// a multiply and an add into an FMA, which rounds once):
//   u = x*x;  p = c7;  p = p*u + c_k for k = 6 .. 0;
//   g = (0.5*x) * (x*p + 1);  g = x if x > 4;  g = 0 if x < -4
// and rounds g to bf16 once, so its output is bit for bit the chain's.  NaN
// passes through the polynomial.  The backward is the chain's reverse mode
// as PyTorch's autograd takes it, in the same order: the two clamps' masks
// on dy, the product rule at (0.5*x) * (x*p + 1), the Horner steps'
// gradients with u's summed from the last step to the first, then x's
// gradient summed from the clamp, from x*p, from 0.5*x and twice from u =
// x*x, in the order the autograd engine adds them.  Its value is
// dy * (0.5 + x P(u) + x^3 P'(u)) inside |x| <= 4, dy above 4 and 0 below
// -4, where P(u) does not overflow (|x| up to about 2000; beyond, 0 * inf
// gives NaN, as it does in autograd).  dx is rounded to bf16 once.
//
// Bound.  Below the card's ridge point: the forward at the extraction shape
// [64, 1568, 3072] reads 617 MB and writes 617 MB (0.37 ms at 3.35 TB/s)
// for about 20 f32 operations an element; the backward reads x and dy and
// writes dx, 6 bytes and about 60 operations an element, near the ridge of
// the card's f32 pipes (about 30 T instructions/s) and its bytes.
//
// Design: each thread moves 16 bytes (8 bf16) a load or a store, kUnroll
// loads of each input in flight before any arithmetic, neighbouring
// threads on neighbouring 16-byte pieces; the n % 8 elements past the last
// whole piece go to the first threads of block 0.  Indices are 64-bit.
// Where a pointer does not start on 16 bytes (a view into a buffer), a
// scalar kernel takes the whole tensor, one element a thread.
//
// The library has a plain C interface, loaded with ctypes: pointers and the
// stream are passed as void*, the element count as long long.  Tensors are
// contiguous bf16 of n elements (the Python wrapper ensures it); outputs are
// written whole.  Each entry point launches on the given stream, allocates
// nothing, does not synchronise, launches nothing for n = 0, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kVec = 8;     // bf16 in one 16-byte access
constexpr int kUnroll = 2;  // 16-byte accesses of each input in flight a thread

// GELU_ERF_POLY_COEF of bvc_tpu_torch/ops/gelu.py, c0 .. c7, each a double
// rounded once to f32, as PyTorch rounds a Python float scalar.
constexpr float kC0 = static_cast<float>(7.9734678899e-01);
constexpr float kC1 = static_cast<float>(-1.3177568632e-01);
constexpr float kC2 = static_cast<float>(1.9010796243e-02);
constexpr float kC3 = static_cast<float>(-2.0129805657e-03);
constexpr float kC4 = static_cast<float>(1.4971004030e-04);
constexpr float kC5 = static_cast<float>(-7.3142603991e-06);
constexpr float kC6 = static_cast<float>(2.0839182688e-07);
constexpr float kC7 = static_cast<float>(-2.6025839423e-09);
constexpr float kClamp = 4.0f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// Horner's values q[0] = c7, q[i] = q[i-1]*u + c_(7-i); q[7] = P(u).
__device__ __forceinline__ void horner(float u, float (&q)[8]) {
  q[0] = kC7;
  q[1] = add(mul(q[0], u), kC6);
  q[2] = add(mul(q[1], u), kC5);
  q[3] = add(mul(q[2], u), kC4);
  q[4] = add(mul(q[3], u), kC3);
  q[5] = add(mul(q[4], u), kC2);
  q[6] = add(mul(q[5], u), kC1);
  q[7] = add(mul(q[6], u), kC0);
}

__device__ __forceinline__ float gelu_f32(float x) {
  float q[8];
  horner(mul(x, x), q);
  float g = mul(mul(x, 0.5f), add(mul(x, q[7]), 1.0f));
  g = x > kClamp ? x : g;
  return x < -kClamp ? 0.0f : g;
}

__device__ __forceinline__ float gelu_grad_f32(float x, float dy) {
  const float u = mul(x, x);
  float q[8];
  horner(u, q);
  const float a = mul(x, 0.5f);
  const float b = add(mul(x, q[7]), 1.0f);
  float gg = x < -kClamp ? 0.0f : dy;  // through g = 0 if x < -4
  float dx = x > kClamp ? gg : 0.0f;   // through g = x if x > 4
  gg = x > kClamp ? 0.0f : gg;
  const float ga = mul(gg, b);  // of 0.5*x
  const float gb = mul(gg, a);  // of x*p + 1
  dx = add(dx, mul(gb, q[7]));
  float gp = mul(gb, x);
  dx = add(dx, mul(ga, 0.5f));
  float gu = mul(gp, q[6]);
  gp = mul(gp, u);
#pragma unroll
  for (int i = 6; i >= 1; --i) {
    gu = add(gu, mul(gp, q[i - 1]));
    gp = mul(gp, u);
  }
  const float gx = mul(gu, x);  // each factor of u = x*x
  return add(add(dx, gx), gx);
}

// The two bf16 of a 32-bit word as f32 (exact), element 0 in the low half.
__device__ __forceinline__ float low(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float high(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Two f32 rounded to bf16 (round to nearest even, as PyTorch's cast on the
// card) in one word, a in the low half.
__device__ __forceinline__ uint32_t pack(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(a)))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(b))) << 16);
}

__device__ __forceinline__ uint32_t gelu_word(uint32_t x) {
  return pack(gelu_f32(low(x)), gelu_f32(high(x)));
}

__device__ __forceinline__ uint32_t gelu_grad_word(uint32_t x, uint32_t dy) {
  return pack(gelu_grad_f32(low(x), low(dy)), gelu_grad_f32(high(x), high(dy)));
}

__global__ void __launch_bounds__(kThreads)
    gelu_fwd_vec(const bf16* __restrict__ x, bf16* __restrict__ y, long long n) {
  const long long pieces = n / kVec;
  const long long first = static_cast<long long>(blockIdx.x) * (kThreads * kUnroll) + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  uint4 in[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long i = first + static_cast<long long>(j) * kThreads;
    if (i < pieces) in[j] = xv[i];
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long i = first + static_cast<long long>(j) * kThreads;
    if (i < pieces) {
      yv[i] = make_uint4(gelu_word(in[j].x), gelu_word(in[j].y), gelu_word(in[j].z),
                         gelu_word(in[j].w));
    }
  }
  const long long tail = pieces * kVec + threadIdx.x;
  if (blockIdx.x == 0 && tail < n) {
    y[tail] = __float2bfloat16(gelu_f32(__bfloat162float(x[tail])));
  }
}

__global__ void __launch_bounds__(kThreads)
    gelu_bwd_vec(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                 bf16* __restrict__ dx, long long n) {
  const long long pieces = n / kVec;
  const long long first = static_cast<long long>(blockIdx.x) * (kThreads * kUnroll) + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* dyv = reinterpret_cast<const uint4*>(dy);
  uint4* dxv = reinterpret_cast<uint4*>(dx);
  uint4 in[kUnroll], grad[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long i = first + static_cast<long long>(j) * kThreads;
    if (i < pieces) {
      in[j] = xv[i];
      grad[j] = dyv[i];
    }
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long i = first + static_cast<long long>(j) * kThreads;
    if (i < pieces) {
      dxv[i] = make_uint4(
          gelu_grad_word(in[j].x, grad[j].x), gelu_grad_word(in[j].y, grad[j].y),
          gelu_grad_word(in[j].z, grad[j].z), gelu_grad_word(in[j].w, grad[j].w));
    }
  }
  const long long tail = pieces * kVec + threadIdx.x;
  if (blockIdx.x == 0 && tail < n) {
    dx[tail] = __float2bfloat16(
        gelu_grad_f32(__bfloat162float(x[tail]), __bfloat162float(dy[tail])));
  }
}

__global__ void __launch_bounds__(kThreads)
    gelu_fwd_scalar(const bf16* __restrict__ x, bf16* __restrict__ y, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) y[i] = __float2bfloat16(gelu_f32(__bfloat162float(x[i])));
}

__global__ void __launch_bounds__(kThreads)
    gelu_bwd_scalar(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                    bf16* __restrict__ dx, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) {
    dx[i] = __float2bfloat16(gelu_grad_f32(__bfloat162float(x[i]), __bfloat162float(dy[i])));
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

unsigned vec_blocks(long long n) {
  const long long per_block = static_cast<long long>(kThreads) * kUnroll * kVec;
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

unsigned scalar_blocks(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// y = gelu_poly(x), both contiguous bf16 of n elements.
extern "C" int bvc_gelu_poly_fwd(const void* x, void* y, long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* yp = static_cast<bf16*>(y);
  if (aligned16(x) && aligned16(y)) {
    gelu_fwd_vec<<<vec_blocks(n), kThreads, 0, st>>>(xp, yp, n);
  } else {
    gelu_fwd_scalar<<<scalar_blocks(n), kThreads, 0, st>>>(xp, yp, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// dx = dy * gelu_poly'(x), all three contiguous bf16 of n elements.
extern "C" int bvc_gelu_poly_bwd(const void* x, const void* dy, void* dx, long long n,
                                 void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* dyp = static_cast<const bf16*>(dy);
  bf16* dxp = static_cast<bf16*>(dx);
  if (aligned16(x) && aligned16(dy) && aligned16(dx)) {
    gelu_bwd_vec<<<vec_blocks(n), kThreads, 0, st>>>(xp, dyp, dxp, n);
  } else {
    gelu_bwd_scalar<<<scalar_blocks(n), kThreads, 0, st>>>(xp, dyp, dxp, n);
  }
  return static_cast<int>(cudaGetLastError());
}
