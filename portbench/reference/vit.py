"""Plain transformer parts of the reference: f32 PyTorch, TF32 off, no
kernel, no cache, written from the published descriptions (pre-LN ViT
blocks with a fused qkv, erf GELU, LayerNorm, softmax attention with an
optional key mask; the HF VideoMAE 1-D sinusoid table; the V-JEPA
``PositionalEncoding3D`` table).

Parameters come as a flat dict of tensors under the program's names
(``blocks.layers.{i}.{ln1,qkv,proj,ln2,fc1,fc2}.{weight,bias}``, weights
in the ``nn.Linear`` layout ``[out, in]``): the benchmark makes one set of
weights from the seed and hands the same tensors to both sides.

:class:`Precision` is where every product of the reference goes.  ``f32``
is the reference; ``fp8`` is the control, the reference put in the
program's place one precision below the configuration's bf16, as fp8
training recipes compute: both operands of every product rounded to float8
e4m3 before an f32 product, and every gradient that flows back through an
operand rounded to float8 e5m2, each tensor scaled by its largest
magnitude.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0  # largest finite float8 e4m3 value
E5M2_MAX = 57344.0  # largest finite float8 e5m2 value


def tf32_off() -> None:
    """Full f32 products on the card: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` after scaling its largest magnitude to
    ``top``, and scaled back, in f32."""
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """The rounding of the operands of every product: ``f32`` (none) or
    ``fp8`` (float8 e4m3 forward, e5m2 for the gradients back)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.kind == "f32" else _Fp8.apply(x)


F32 = Precision("f32")


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
           prec: Precision = F32) -> torch.Tensor:
    return F.linear(prec.q(x), prec.q(w), b)


def layer_norm(x: torch.Tensor, w: torch.Tensor | None, b: torch.Tensor | None,
               eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_valid: torch.Tensor | None = None, prec: Precision = F32) -> torch.Tensor:
    """Softmax attention over ``[B, N, h, d]``: scores times d^-1/2, keys
    where ``key_valid [B, N]`` is False left out, f32 softmax."""
    scores = torch.einsum("bqhd,bkhd->bhqk", prec.q(q), prec.q(k)) * q.shape[-1] ** -0.5
    if key_valid is not None:
        scores = scores.masked_fill(~key_valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", prec.q(probs), prec.q(v))


def block(p: dict, pre: str, x: torch.Tensor, heads: int, eps: float,
          key_valid: torch.Tensor | None = None, prec: Precision = F32) -> torch.Tensor:
    """One pre-LN block: ``x + proj(attn(qkv(ln1(x))))``, then ``x +
    fc2(gelu(fc1(ln2(x))))``."""
    B, N, D = x.shape
    h = layer_norm(x, p[pre + "ln1.weight"], p[pre + "ln1.bias"], eps)
    qkv = linear(h, p[pre + "qkv.weight"], p[pre + "qkv.bias"], prec)
    qkv = qkv.reshape(B, N, 3, heads, D // heads)
    a = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], key_valid, prec)
    x = x + linear(a.reshape(B, N, D), p[pre + "proj.weight"], p[pre + "proj.bias"], prec)
    h = layer_norm(x, p[pre + "ln2.weight"], p[pre + "ln2.bias"], eps)
    h = F.gelu(linear(h, p[pre + "fc1.weight"], p[pre + "fc1.bias"], prec))
    return x + linear(h, p[pre + "fc2.weight"], p[pre + "fc2.bias"], prec)


def blocks(p: dict, pre: str, x: torch.Tensor, depth: int, heads: int, eps: float,
           key_valid: torch.Tensor | None = None, prec: Precision = F32) -> torch.Tensor:
    for i in range(depth):
        x = block(p, f"{pre}layers.{i}.", x, heads, eps, key_valid, prec)
    return x


def normalize(video: torch.Tensor) -> torch.Tensor:
    """uint8 frames to ``(x / 255 - 0.5) / 0.25`` in f32."""
    return (video.float() / 255.0 - 0.5) / 0.25


def patch_embed(video: torch.Tensor, w: torch.Tensor, b: torch.Tensor, ts: int, p: int,
                prec: Precision = F32) -> torch.Tensor:
    """A Conv3d of kernel and stride ``(ts, p, p)`` over normalized
    ``[B, T, H, W, C]`` video, its weight given flat ``[D, C*ts*p*p]``
    (the Conv3d weight ``[D, C, ts, p, p]`` flattened); ``[B, N, D]``, the
    tokens time-major then row-major."""
    D, C = w.shape[0], video.shape[-1]
    x = prec.q(video).permute(0, 4, 1, 2, 3)
    y = F.conv3d(x, prec.q(w).reshape(D, C, ts, p, p), b, stride=(ts, p, p))
    return y.flatten(2).transpose(1, 2)


def sinusoid_table(n: int, d: int) -> torch.Tensor:
    """HF VideoMAE's ``[n, d]`` table: angle ``pos / 10000^(2*(j//2)/d)``,
    sin on even channels, cos on odd."""
    j = np.arange(d)
    angle = np.arange(n, dtype=np.float64)[:, None] / np.power(10000.0, 2 * (j // 2) / d)
    table = np.where(j % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.from_numpy(table.astype(np.float32))


def position_table_3d(t: int, h: int, w: int, channels: int) -> torch.Tensor:
    """V-JEPA's ``PositionalEncoding3D`` on a ``(t, h, w)`` grid, flattened
    t-major: three channel blocks of ``ceil(C/6)*2`` for t, y and x, each
    of interleaved (sin, cos) pairs at frequencies 10000^(-2i/block), the
    last block cut back to C."""
    blk = int(math.ceil(channels / 6) * 2)
    blk += blk % 2
    inv = 1.0 / 10000 ** (np.arange(0, blk, 2, dtype=np.float64) / blk)

    def axis(n: int) -> np.ndarray:
        ang = np.arange(n, dtype=np.float64)[:, None] * inv[None, :]
        return np.stack([np.sin(ang), np.cos(ang)], axis=-1).reshape(n, blk)

    table = np.concatenate(np.broadcast_arrays(axis(t)[:, None, None], axis(h)[None, :, None],
                                               axis(w)[None, None, :]), axis=-1)
    return torch.from_numpy(table[..., :channels].reshape(t * h * w, channels)
                            .astype(np.float32))
