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

Under tensor parallelism (``--param_sharding tp``,
:meth:`Block.split_heads`) a block holds its
rank's heads: the rows of ``qkv`` that are its heads of q, k and v, its
columns of ``proj``, its rows of ``fc1`` and columns of ``fc2``.  The
attention runs on the local heads, through the same kernels and routing;
Megatron's "f" (:func:`~bvc_tpu_torch.parallel.collectives.copy_to_model`)
enters each half of the block and "g" (:func:`~bvc_tpu_torch.parallel.
collectives.reduce_from_model`) sums the row-parallel products over the
model ranks, the biases of ``proj`` and ``fc2`` added once after the sum,
as the JAX package's TP block adds them.

Rotary positions (V-JEPA 2's 3-D RoPE, :mod:`bvc_tpu_torch.ops.rope`): a
block built with a ``rope_grid`` and called with token ids ``pos`` rotates
its queries and keys by them before the attention; called without, it runs
as a block without positions.

Stochastic depth (:func:`drop_path`, JEPA only, off in every reference
config) and activation checkpointing (``remat``: each block's activations
recomputed in the backward, as the JAX package's ``run_blocks(..., remat)``)
are options of :class:`Blocks`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from bvc_tpu_torch.models.initializers import init_linear
from bvc_tpu_torch.ops.attention import multi_head_attention
from bvc_tpu_torch.ops.flash_attention import key_bias
from bvc_tpu_torch.ops.gelu import gelu
from bvc_tpu_torch.ops.quant import QuantLinear, qdense
from bvc_tpu_torch.ops.rope import rope3d
from bvc_tpu_torch.parallel.collectives import copy_to_model, reduce_from_model
from bvc_tpu_torch.parallel.sharding import TP_RULES, TPSplit
from bvc_tpu_torch.utils.profiling import profiler_range


def drop_path(x: torch.Tensor, keep: torch.Tensor | None, keep_prob: float = 1.0
              ) -> torch.Tensor:
    """Per-sample stochastic depth on a residual branch ``x [B, ...]``:
    ``keep [B]`` is a Bernoulli(``keep_prob``) draw, and the surviving
    branches are scaled by ``1 / keep_prob`` in ``x``'s dtype, as the JAX
    package's ``drop_path`` computes ``x * (mask / keep)``; None is the
    identity."""
    if keep is None:
        return x
    keep_prob = torch.tensor(keep_prob, dtype=x.dtype).item()  # rounded as JAX casts it
    scale = keep.to(x.dtype) / keep_prob
    return x * scale.reshape((-1,) + (1,) * (x.ndim - 1))


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None,
               bias: torch.Tensor | None, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics, cast back to the
    input dtype; ``weight``/``bias`` None is the unit affine.  A
    ``bvc::layer_norm`` range while a profiler records."""
    with profiler_range("layer_norm"):
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


def _row_parallel(x: torch.Tensor, layer: nn.Linear, group) -> torch.Tensor:
    """A row-parallel layer over the model ranks: this rank's product,
    summed over the ranks, then the (whole) bias."""
    out = reduce_from_model(F.linear(x, layer.weight.to(x.dtype)), group)
    return out + layer.bias.to(x.dtype)


class Block(nn.Module):
    """One pre-LN transformer block on ``[B, N, D]`` (``block_apply``)."""

    shard_unit = True  # FSDP2 shards the model block by block

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, ln_eps: float = 1e-6,
                 init_std: float = 0.02, generator: torch.Generator | None = None,
                 rope_grid: tuple[int, int, int] | None = None):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.num_heads = num_heads
        self.rope_grid = rope_grid  # the (T, H, W) grid of the ids ``pos`` names
        # the model ranks' group and count once split_heads split the block
        self.tp_group, self.tp_size = None, 1
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

    def split_heads(self, group, size: int, rank: int) -> None:
        """Keep model rank ``rank``'s part of each parameter that
        :data:`~bvc_tpu_torch.parallel.sharding.TP_RULES` splits over the
        ``size`` ranks of ``group`` (tagged ``tp_split``): its heads of q, k
        and v, its rows of ``fc1``, its columns of ``proj`` and ``fc2``.
        Heads or an MLP width that do not divide by ``size`` leave the
        block whole (the JAX package splits its columns anyway and GSPMD
        reshards them: the numbers are the same)."""
        if self.num_heads % size or self.fc1.out_features % size:
            return
        for name, dim, parts in TP_RULES:
            layer, attr = name.split(".")
            old = getattr(getattr(self, layer), attr)
            if old is None:
                continue
            spec = TPSplit(dim, parts, size, rank, group)
            new = nn.Parameter(spec.split(old.detach()), requires_grad=old.requires_grad)
            new.tp_split = spec
            setattr(getattr(self, layer), attr, new)
        self.tp_group, self.tp_size = group, size

    def forward(self, x: torch.Tensor, attn_impl: str = "auto",
                bias: torch.Tensor | None = None, drop_keep: torch.Tensor | None = None,
                keep_prob: float = 1.0, pos: torch.Tensor | None = None) -> torch.Tensor:
        """``bias``: the ``[B, N]`` f32 key bias that :class:`Blocks` builds
        from its key mask, or None; ``drop_keep``: ``[2, B]`` bool drop-path
        draws (Bernoulli(``keep_prob``)) of the attention and MLP branches,
        or None; ``pos``: ``[B, N]`` int32 token ids in ``rope_grid``
        (:func:`~bvc_tpu_torch.ops.rope.rope_positions`) that rotate q and
        k, or None."""
        B, N, D = x.shape
        heads, hd = self.num_heads // self.tp_size, D // self.num_heads
        tp = self.tp_size > 1
        h = self.ln1(x)
        if tp:
            h = copy_to_model(h, self.tp_group)
        qkv = _dense(h, self.qkv).reshape(B, N, 3, heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if pos is not None:
            q, k = rope3d(q, k, pos, self.rope_grid)
        attn = multi_head_attention(q, k, v, impl=attn_impl, bias=bias).reshape(B, N, heads * hd)
        attn = _row_parallel(attn, self.proj, self.tp_group) if tp else _dense(attn, self.proj)
        x = x + drop_path(attn, None if drop_keep is None else drop_keep[0], keep_prob)
        h = self.ln2(x)
        if tp:
            h = copy_to_model(h, self.tp_group)
        h = gelu(_dense(h, self.fc1))
        h = _row_parallel(h, self.fc2, self.tp_group) if tp else _dense(h, self.fc2)
        return x + drop_path(h, None if drop_keep is None else drop_keep[1], keep_prob)


class Blocks(nn.Module):
    """A stack of ``depth`` blocks run in order (``run_blocks``).

    ``remat=True`` wraps each block in ``torch.utils.checkpoint`` (non
    reentrant) while gradients are on: its activations are dropped after
    the forward and recomputed in the backward, with the same key bias and
    the same drop-path draw, which come in as arguments."""

    def __init__(self, depth: int, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, ln_eps: float = 1e-6, init_std: float = 0.02,
                 generator: torch.Generator | None = None, remat: bool = False,
                 rope_grid: tuple[int, int, int] | None = None):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            Block(dim, num_heads, mlp_ratio, qkv_bias, ln_eps, init_std, generator, rope_grid)
            for _ in range(depth))

    def forward(self, x: torch.Tensor, attn_impl: str = "auto",
                key_mask: torch.Tensor | None = None, drop_path_rate: float = 0.0,
                generator: torch.Generator | None = None,
                pos: torch.Tensor | None = None) -> torch.Tensor:
        """``key_mask`` (``[B, N]`` bool, True = attendable) becomes its f32
        key bias once here, for every layer.  With ``drop_path_rate > 0``
        and a ``generator`` (training), layer i drops its branches per
        sample at the reference's rate ``linspace(0, drop_path_rate,
        depth)[i]``, drawn from ``generator`` before the layer runs.
        ``pos``: the tokens' ids for every layer's rotary positions, or
        None (see :meth:`Block.forward`)."""
        bias = None if key_mask is None else key_bias(key_mask)
        rates = (np.linspace(0.0, drop_path_rate, len(self.layers))
                 if drop_path_rate > 0 and generator is not None else None)
        remat = self.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            keep, keep_prob = None, 1.0
            if rates is not None and rates[i] > 0:
                keep_prob = 1.0 - float(rates[i])
                # independent draws for the two branches, as the reference's
                # two drop_path calls
                keep = torch.rand((2, x.shape[0]), generator=generator,
                                  device=generator.device) < keep_prob
            if remat:
                x = torch.utils.checkpoint.checkpoint(layer, x, attn_impl, bias, keep,
                                                      keep_prob, pos, use_reentrant=False,
                                                      preserve_rng_state=False)
            else:
                x = layer(x, attn_impl, bias, keep, keep_prob, pos)
        return x


def block_attention_probs(block: Block, x: torch.Tensor) -> torch.Tensor:
    """Attention probabilities ``[B, h, N, N]`` (f32) of one block on ``x``
    ``[B, N, D]``: the reference's ``Block.forward(return_attention=True)``
    introspection path (``vision_transformer.py:225-228``), used for
    attention-map visualisation.  LN1, ``qkv`` through :func:`_dense` (a
    :class:`~bvc_tpu_torch.ops.quant.QuantLinear` through ``qdense``), f32
    scores times ``d^-0.5`` and a softmax; plain torch, as the JAX package
    computes it outside any kernel.  Not on the training path: it holds the
    N^2 scores of every head."""
    if block.rope_grid is not None:
        raise ValueError("block_attention_probs: a block with rotary positions "
                         "(rope_grid) needs its tokens' ids, which this path does not take")
    B, N, D = x.shape
    heads, hd = block.num_heads // block.tp_size, D // block.num_heads
    qkv = _dense(block.ln1(x), block.qkv).reshape(B, N, 3, heads, hd)
    q, k = qkv[:, :, 0].float(), qkv[:, :, 1].float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    return torch.softmax(logits, dim=-1)
