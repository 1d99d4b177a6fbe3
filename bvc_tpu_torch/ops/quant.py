"""W8A8 dynamic-quantized dense for the extraction path (counterpart of
:mod:`bvc_tpu.ops.quant`).

- Per-output-channel symmetric weight quantization, once at load time
  (:func:`quantize_linear`, :func:`quantize_blocks`,
  :func:`quantize_encoder`): ``scale[j] = max(max_i |W[j, i]|, 1e-12) /
  127`` and ``weight_q = clamp(round(W / scale), -127, 127)`` in int8, held
  by a :class:`QuantLinear` in the ``nn.Linear`` layout ``[Dout, Din]``.
- Per-token dynamic activation quantization inside :func:`qdense`, in plain
  PyTorch as the JAX package computes it outside any kernel:
  ``xscale = max(max |x[t, :]|, 1e-12) / 127`` and ``xq = clamp(round(x /
  xscale), -127, 127)`` in int8 (a division, not a product with the
  reciprocal, so that ``xq`` rounds as JAX's does at ties).
- The int8 product with int32 accumulation and the dequant
  ``(acc * xscale) * scale (+ bias)`` in f32 run in one launch of the s8
  kernel of ``csrc/gemm.cu`` (:func:`bvc_tpu_torch.ops.gemm.int8_matmul`),
  cast to the compute dtype on the way out.

An encoder quantizes :data:`EXPANSION_MATMULS`, the JAX package's choice
(:func:`quantize_blocks` takes any of :data:`ALL_MATMULS`); LayerNorm,
GELU, attention, the patch embedding and the residuals stay in the regular
path.
"""

from __future__ import annotations

import torch
from torch import nn

from bvc_tpu_torch.ops.gemm import int8_matmul, int8_matmul_ref

# symmetric int8: -128 is excluded, so |dequant| <= 127 * scale exactly
_QMAX = 127.0
EXPANSION_MATMULS: tuple[str, ...] = ("attn.qkv", "mlp.fc1")
ALL_MATMULS: tuple[str, ...] = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")
_BLOCK_ATTRS = {"attn.qkv": "qkv", "attn.proj": "proj", "mlp.fc1": "fc1", "mlp.fc2": "fc2"}


class QuantLinear(nn.Module):
    """An int8 linear layer's weights: buffers ``weight_q`` (int8 ``[Dout,
    Din]``), ``scale`` (f32 ``[Dout]``) and ``bias`` (f32 ``[Dout]`` or
    None); :func:`qdense` applies it."""

    def __init__(self, weight_q: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)


def quantize_linear(layer: nn.Linear) -> QuantLinear:
    """The :class:`QuantLinear` of an ``nn.Linear``, on the layer's device:
    bit-identical to JAX's ``quantize_linear`` on the same f32 weights, up to
    the transpose."""
    w = layer.weight.detach().float()
    scale = torch.clamp(w.abs().amax(dim=1), min=1e-12) / _QMAX
    weight_q = torch.clamp(torch.round(w / scale[:, None]), -_QMAX, _QMAX).to(torch.int8)
    bias = None if layer.bias is None else layer.bias.detach().float().clone()
    return QuantLinear(weight_q, scale, bias)


def quantize_blocks(blocks: nn.Module, layers: tuple[str, ...] = EXPANSION_MATMULS
                    ) -> nn.Module:
    """Replace the selected matmuls of every layer of a
    :class:`~bvc_tpu_torch.models.vit.Blocks` stack by their
    :class:`QuantLinear`, in place; returns the stack.  ``layers`` entries
    are names from :data:`ALL_MATMULS`."""
    unknown = set(layers) - set(ALL_MATMULS)
    if unknown:
        raise ValueError(f"unknown block matmuls {sorted(unknown)}; "
                         f"valid: {ALL_MATMULS}")
    for block in blocks.layers:
        for path in layers:
            attr = _BLOCK_ATTRS[path]
            layer = getattr(block, attr)
            if isinstance(layer, nn.Linear):
                setattr(block, attr, quantize_linear(layer))
    return blocks


def quantize_encoder(model: nn.Module) -> nn.Module:
    """Quantize the :data:`EXPANSION_MATMULS` of ``model.blocks`` (where
    ``VideoMAEEncoder`` and ``JEPAEncoder`` keep their stack) in place;
    returns the model."""
    quantize_blocks(model.blocks)
    return model


def quantize_tokens(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8 quantization of ``x [..., D]``: ``(xq int8 [..., D],
    xscale f32 [..., 1])``."""
    xf = x.float()
    xscale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-12) / _QMAX
    xq = torch.clamp(torch.round(xf / xscale), -_QMAX, _QMAX).to(torch.int8)
    return xq, xscale


def _qdense(matmul, x: torch.Tensor, layer: QuantLinear,
            dtype: torch.dtype | None) -> torch.Tensor:
    lead, din = x.shape[:-1], x.shape[-1]
    xq, xscale = quantize_tokens(x.reshape(-1, din))
    out = matmul(xq, layer.weight_q, xscale.reshape(-1), layer.scale, layer.bias,
                 dtype or x.dtype)
    return out.reshape(*lead, out.shape[-1])


def qdense(x: torch.Tensor, layer: QuantLinear, dtype: torch.dtype | None = None
           ) -> torch.Tensor:
    """W8A8 dense over ``x [..., Din]``: per-token quantization, then one
    s8 kernel launch for the product and its dequant on CUDA tensors (the
    plain version on CPU tensors), out in ``dtype`` (bf16 or f32; ``x``'s
    dtype when None).  Drop-in for a dense with ``layer``'s weights."""
    return _qdense(int8_matmul, x, layer, dtype)


def qdense_ref(x: torch.Tensor, layer: QuantLinear, dtype: torch.dtype | None = None
               ) -> torch.Tensor:
    """:func:`qdense` through the plain product on any device, which
    ``chip_smoke.py`` holds the kernel path against on the card."""
    return _qdense(int8_matmul_ref, x, layer, dtype)

