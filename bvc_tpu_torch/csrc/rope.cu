// 3-D rotary position embeddings on bf16 attention queries and keys,
// forward and backward, one pass over memory each: the rotation of
// bvc_tpu_torch/ops/rope.py (rope_rotate), evaluated in f32.
//
// Replaces no TPU kernel: the JAX package has no rotary embeddings.  In
// eager PyTorch the rotation is about fifteen elementwise kernels over q and
// k in f32 (the gathers of cos and sin, the four products, the difference
// and the sum, the stack, the concatenation and the casts), each reading and
// writing the whole [B, N, h, d] tensor.
//
// Arithmetic.  Pair p of a head (channels 2p and 2p+1, p < P) at a token of
// position pos turns by the angle whose cosine and sine are cos[pos*P + p]
// and sin[pos*P + p] (f32 tables built once by the Python side):
//   y0 = x0*c - x1*s;  y1 = x1*c + x0*s
// each product and each sum rounded on its own (__fmul_rn, __fsub_rn,
// __fadd_rn keep nvcc from contracting them into an FMA), as the eager
// chain computes them, then rounded to bf16 once: the output is the
// chain's bit for bit.  Channels 2P .. d-1 are copied unchanged.  The
// backward is the same rotation with -s, which gives dy0*c + dy1*s and
// dy1*c - dy0*s exactly (negation is exact): autograd's gradient through
// the chain, bit for bit up to the sign of a zero.
//
// Bound.  Bytes: the forward reads q and k and writes both, 8 bytes an
// element of q, plus the positions (4 bytes a token) and the tables (read
// once per token from L1/L2); at V-JEPA 2 ViT-g's [16, 2048, 22, 64] that is
// 369 MB, 0.110 ms at 3.35 TB/s.  About 6 f32 operations an element.
//
// Design: a thread takes one 16-byte piece (8 channels, 4 pairs) of one
// token's q row and the same piece of its k row, so the position and the 4
// cosines and sines it needs are loaded once for both.  Each token's h*d
// values of q (and of k) lie in one run starting at b*stride_b + n*stride_n
// elements, on the 16-byte grid (the Python side checks it, else copies):
// the q and k slices of the fused [B, N, 3, h, d] qkv product are read in
// place.  Outputs are contiguous [B, N, h, d].  Indices of pieces are
// 32-bit (the wrapper's shapes stay far below 2^32 pieces), element
// offsets 64-bit.
//
// The library has a plain C interface, loaded with ctypes: pointers and the
// stream are passed as void*, sizes and strides (in elements) as long long.
// Each entry point launches on the given stream, allocates nothing, does not
// synchronise, launches nothing for an empty tensor, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 in one 16-byte piece

__device__ __forceinline__ float low(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float high(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Two f32 rounded to bf16 (round to nearest even, as PyTorch's cast on the
// card) in one word, a in the low half.
__device__ __forceinline__ uint32_t pack(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(a)))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(b))) << 16);
}

// One pair (x0 in the low half of w, x1 in the high half) turned by (c, s).
__device__ __forceinline__ uint32_t turn(uint32_t w, float c, float s) {
  const float x0 = low(w), x1 = high(w);
  return pack(__fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s)),
              __fadd_rn(__fmul_rn(x1, c), __fmul_rn(x0, s)));
}

struct Args {
  const bf16* x;
  const bf16* y;
  const float* cos;
  const float* sin;
  const int* pos;
  bf16* ox;
  bf16* oy;
  unsigned tokens, N, row_pieces, head_pieces, P;
  long long x_sb, x_sn, y_sb, y_sn;
};

template <bool kInverse>
__device__ __forceinline__ void rotate_piece(const Args& a) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.tokens * a.row_pieces) return;
  const unsigned token = i / a.row_pieces;
  const unsigned piece = i - token * a.row_pieces;
  const unsigned b = token / a.N, n = token - b * a.N;
  const long long off = static_cast<long long>(piece) * kVec;
  const uint4 xv = *reinterpret_cast<const uint4*>(a.x + b * a.x_sb + n * a.x_sn + off);
  const uint4 yv = *reinterpret_cast<const uint4*>(a.y + b * a.y_sb + n * a.y_sn + off);
  const unsigned p0 = (piece % a.head_pieces) * (kVec / 2);  // first pair of the piece
  uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
  uint32_t yw[4] = {yv.x, yv.y, yv.z, yv.w};
  if (p0 < a.P) {
    const long long row = static_cast<long long>(a.pos[token]) * a.P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned p = p0 + j;
      if (p < a.P) {
        const float c = a.cos[row + p];
        const float s = kInverse ? -a.sin[row + p] : a.sin[row + p];
        xw[j] = turn(xw[j], c, s);
        yw[j] = turn(yw[j], c, s);
      }
    }
  }
  const long long out = static_cast<long long>(token) * a.row_pieces * kVec + off;
  *reinterpret_cast<uint4*>(a.ox + out) = make_uint4(xw[0], xw[1], xw[2], xw[3]);
  *reinterpret_cast<uint4*>(a.oy + out) = make_uint4(yw[0], yw[1], yw[2], yw[3]);
}

__global__ void __launch_bounds__(kThreads) rope3d_fwd_vec(const Args a) {
  rotate_piece<false>(a);
}

__global__ void __launch_bounds__(kThreads) rope3d_bwd_vec(const Args a) {
  rotate_piece<true>(a);
}

int run(bool inverse, const void* x, const void* y, const void* cos, const void* sin,
        const void* pos, void* ox, void* oy, long long B, long long N, long long h,
        long long d, long long P, long long x_sb, long long x_sn, long long y_sb,
        long long y_sn, void* stream) {
  if (B < 0 || N < 0 || h < 0 || d <= 0 || d % kVec || P < 0 || 2 * P > d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long pieces = B * N * (h * d / kVec);
  if (pieces == 0) return static_cast<int>(cudaSuccess);
  if (pieces >= (1LL << 32) - kThreads) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.y = static_cast<const bf16*>(y);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.pos = static_cast<const int*>(pos);
  a.ox = static_cast<bf16*>(ox);
  a.oy = static_cast<bf16*>(oy);
  a.tokens = static_cast<unsigned>(B * N);
  a.N = static_cast<unsigned>(N);
  a.row_pieces = static_cast<unsigned>(h * d / kVec);
  a.head_pieces = static_cast<unsigned>(d / kVec);
  a.P = static_cast<unsigned>(P);
  a.x_sb = x_sb;
  a.x_sn = x_sn;
  a.y_sb = y_sb;
  a.y_sn = y_sn;
  const unsigned blocks = static_cast<unsigned>((pieces + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (inverse) {
    rope3d_bwd_vec<<<blocks, kThreads, 0, st>>>(a);
  } else {
    rope3d_fwd_vec<<<blocks, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ox, oy = the rotation of x and y ([B, N, h, d] bf16 read through their
// batch and token strides) at the positions pos [B, N] (int32).
extern "C" int bvc_rope3d_fwd(const void* x, const void* y, const void* cos, const void* sin,
                              const void* pos, void* ox, void* oy, long long B, long long N,
                              long long h, long long d, long long P, long long x_sb,
                              long long x_sn, long long y_sb, long long y_sn, void* stream) {
  return run(false, x, y, cos, sin, pos, ox, oy, B, N, h, d, P, x_sb, x_sn, y_sb, y_sn, stream);
}

// The same with the angles negated: the gradients of x and y from those of
// the rotated tensors.
extern "C" int bvc_rope3d_bwd(const void* x, const void* y, const void* cos, const void* sin,
                              const void* pos, void* ox, void* oy, long long B, long long N,
                              long long h, long long d, long long P, long long x_sb,
                              long long x_sn, long long y_sb, long long y_sn, void* stream) {
  return run(true, x, y, cos, sin, pos, ox, oy, B, N, h, d, P, x_sb, x_sn, y_sb, y_sn, stream);
}
