"""Transformer core (counterpart of :mod:`bvc_tpu.models.vit`).

Pre-LN blocks with fused-qkv attention and an erf-GELU MLP, under the JAX
package's dtype policy, kept by explicit casts rather than autocast:
parameters in f32, activations in the compute dtype (bf16 by default),
LayerNorm statistics and softmax in f32.

Linear layers use ``F.linear`` with the bias fused, where the JAX package
adds the bias after the product: in bf16 the two round at different places.
A block's ``qkv``, ``proj``, ``fc1`` and ``fc2`` may be a
:class:`~bvc_tpu_torch.ops.quant.QuantLinear` (the W8A8 extraction path,
:func:`~bvc_tpu_torch.ops.quant.quantize_encoder`), which runs
:func:`~bvc_tpu_torch.ops.quant.qdense` with the bias added in f32, as the
JAX package's ``qdense`` does.

Drop-path and activation checkpointing (off in every reference config)
come with the training loop (ROADMAP slice 4); until then the models raise
for a config that asks for either (:func:`no_remat`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bvc_tpu_torch.models.initializers import init_linear
from bvc_tpu_torch.ops.attention import multi_head_attention
from bvc_tpu_torch.ops.flash_attention import key_bias
from bvc_tpu_torch.ops.gelu import gelu
from bvc_tpu_torch.ops.quant import QuantLinear, qdense
from bvc_tpu_torch.utils.config import ModelConfig


def no_remat(cfg: ModelConfig) -> None:
    """Raise for ``cfg.remat``: the JAX package checkpoints each block's
    activations then (``run_blocks(..., remat)``), and a model built here
    would silently keep them all."""
    if cfg.remat:
        raise NotImplementedError(
            "remat=True: activation checkpointing of each block comes with the "
            "training loop (ROADMAP slice 4)")


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None,
               bias: torch.Tensor | None, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics, cast back to the
    input dtype; ``weight``/``bias`` None is the unit affine."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight + bias
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    """f32 affine parameters; see :func:`layer_norm`."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def _dense(x: torch.Tensor, layer: nn.Linear | QuantLinear) -> torch.Tensor:
    if isinstance(layer, QuantLinear):  # the W8A8 extraction path (ops/quant.py)
        return qdense(x, layer, x.dtype)
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class Block(nn.Module):
    """One pre-LN transformer block on ``[B, N, D]`` (``block_apply``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, ln_eps: float = 1e-6,
                 init_std: float = 0.02, generator: torch.Generator | None = None):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.num_heads = num_heads
        self.ln1 = LayerNorm(dim, ln_eps)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.ln2 = LayerNorm(dim, ln_eps)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for layer in (self.qkv, self.proj, self.fc1, self.fc2):
            init_linear(layer, init_std, generator)

    def forward(self, x: torch.Tensor, attn_impl: str = "auto",
                bias: torch.Tensor | None = None) -> torch.Tensor:
        """``bias``: the ``[B, N]`` f32 key bias that :class:`Blocks` builds
        from its key mask, or None."""
        B, N, D = x.shape
        h = self.ln1(x)
        qkv = _dense(h, self.qkv).reshape(B, N, 3, self.num_heads, D // self.num_heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = multi_head_attention(q, k, v, impl=attn_impl, bias=bias)
        x = x + _dense(attn.reshape(B, N, D), self.proj)
        h = gelu(_dense(self.ln2(x), self.fc1))
        return x + _dense(h, self.fc2)


class Blocks(nn.Module):
    """A stack of ``depth`` blocks run in order (``run_blocks``)."""

    def __init__(self, depth: int, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, ln_eps: float = 1e-6, init_std: float = 0.02,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.layers = nn.ModuleList(
            Block(dim, num_heads, mlp_ratio, qkv_bias, ln_eps, init_std, generator)
            for _ in range(depth))

    def forward(self, x: torch.Tensor, attn_impl: str = "auto",
                key_mask: torch.Tensor | None = None) -> torch.Tensor:
        """``key_mask`` (``[B, N]`` bool, True = attendable) becomes its f32
        key bias once here, for every layer."""
        bias = None if key_mask is None else key_bias(key_mask)
        for layer in self.layers:
            x = layer(x, attn_impl, bias)
        return x
