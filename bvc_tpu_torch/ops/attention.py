"""Multi-head attention for the ViT stacks.

Counterpart of :mod:`bvc_tpu.ops.attention`.  Callers pass projected q, k,
v of shape ``[B, N, h, d]``.  Two implementations:

- :func:`plain_attention`, the counterpart of ``_xla_attention``: the
  attention written out in PyTorch, with the same dtype steps, f32 or
  bf16-stored logits;
- :func:`bvc_tpu_torch.ops.flash_attention.flash_attention`: the CUDA
  kernels, forward and backward, without a key mask or with a key bias
  (their plain versions for CPU tensors);
- :func:`bvc_tpu_torch.ops.ring_attention.ring_attention` (``impl=
  'ring:seq'``): the same kernels once per hop of a ring over the ``seq``
  ranks of the process's mesh, for a sequence split across them.

:func:`attention_route` is the rule ``'auto'`` and ``'xla_bf16'`` follow.
"""

from __future__ import annotations

import torch

from bvc_tpu_torch.ops.flash_attention import flash_attention, kernel_route, resolve_bias
from bvc_tpu_torch.ops.ring_attention import ring_attention
from bvc_tpu_torch.parallel.mesh import SEQ_AXIS, current_mesh

# The flash kernels take an attention of at least this many tokens.  Set
# from the H100 timing of the unmasked kernels against plain_attention at
# [8, N, 12, 64], N in {160, 392, 784, 1568}, forward alone and forward
# plus backward (chip_smoke.py, PERF.md): the kernels won at every N
# measured, so the threshold is the smallest of them; shorter sequences
# stay unmeasured.
FLASH_MIN_TOKENS = 160
# The same for masked attention, from the key-bias kernels' forward plus
# backward against plain_attention at B=64, 12 heads, about 60% of the keys
# kept, N in {128, 160, 256} at head widths 64 and 32, and at JEPA's own
# [64, 169, 12, 64] and [256, 199, 12, 32] (chip_smoke.py, PERF.md): the
# kernels won at every one, from 128 tokens; shorter stay unmeasured.
FLASH_MIN_MASKED_TOKENS = 128


def attention_route(device_type: str, dtype: torch.dtype, n: int, head_dim: int,
                    masked: bool) -> str:
    """``'flash'`` or ``'xla'`` (plain) for an attention of ``n`` tokens of
    head width ``head_dim``: the counterpart of ``masked_auto_impl`` and the
    JAX package's ``'auto'`` rule, re-derived for the H100.  On CUDA with
    bf16, unmasked attention of ``n >= FLASH_MIN_TOKENS`` at the unmasked
    kernels' width and masked attention of ``n >= FLASH_MIN_MASKED_TOKENS``
    at a key-bias kernel's width go to the kernels
    (:func:`~bvc_tpu_torch.ops.flash_attention.kernel_route`); everything
    else is plain math."""
    min_tokens = FLASH_MIN_MASKED_TOKENS if masked else FLASH_MIN_TOKENS
    if n < min_tokens:
        return "xla"
    return kernel_route(device_type, dtype, head_dim, masked)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, key_mask: torch.Tensor | None = None,
                    score_dtype: torch.dtype = torch.float32,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """Logits stored in ``score_dtype`` (f32, or bf16 as
    ``_xla_attention(score_dtype=bf16)``) then upcast to f32, times
    ``scale``, plus the key bias of ``key_mask`` (``[B, N]`` bool, True =
    attendable, masked keys get -1e30) or ``bias``, that mask's key bias
    already built (see :func:`~bvc_tpu_torch.ops.flash_attention.resolve_bias`),
    f32 softmax, probabilities cast to the input dtype, then P.V in the
    input dtype."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits.to(score_dtype).float() * scale
    bias = resolve_bias(key_mask, bias)
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float | None = None, impl: str = "auto",
                         key_mask: torch.Tensor | None = None,
                         bias: torch.Tensor | None = None) -> torch.Tensor:
    """Scaled dot-product attention over ``[B, N, h, d]`` tensors.

    ``impl``:

    - ``'auto'``: :func:`attention_route` picks the kernels or the plain
      math with f32 logits;
    - ``'xla'``: the plain math with f32 logits (the JAX package's name);
    - ``'xla_bf16'``: where :func:`attention_route` picks plain math, its
      logits are stored in bf16 (softmax in f32), as the JAX package's
      ``'xla_bf16'``; where it picks the kernels, they run, with f32
      scores, as the JAX package defers ``'xla_bf16'`` to flash in its
      flash regime;
    - ``'flash'``: the kernels for CUDA tensors (the backward kernels when a
      gradient is taken), their plain versions for CPU tensors; on CUDA it
      raises for anything but bf16 at a width the kernels take;
    - ``'ring:seq'`` (the JAX package's name): q, k, v are this rank's
      block of a sequence split over the ``seq`` ranks of the process's
      mesh (a ring of one without them); every hop runs the kernels where
      they take the inputs, whatever the block's length, and plain math
      otherwise (:func:`~bvc_tpu_torch.ops.flash_attention.kernel_route`).

    ``key_mask``: ``[B, N]`` bool, True = attendable; or ``bias``, that
    mask's f32 key bias already built (a stack of blocks builds it once,
    see :func:`~bvc_tpu_torch.ops.flash_attention.resolve_bias`).  All
    paths are differentiable.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    bias = resolve_bias(key_mask, bias)
    if impl == f"ring:{SEQ_AXIS}":
        mesh = current_mesh()
        return ring_attention(q, k, v, mesh.group(SEQ_AXIS), mesh.axis_size(SEQ_AXIS),
                              scale=scale, bias=bias)
    score_dtype = torch.float32
    if impl in ("auto", "xla_bf16"):
        if impl == "xla_bf16":
            score_dtype = torch.bfloat16
        impl = attention_route(q.device.type, q.dtype, q.shape[1], q.shape[-1],
                               bias is not None)
    if impl == "flash":
        return flash_attention(q, k, v, scale=scale, bias=bias)
    if impl == "xla":
        return plain_attention(q, k, v, scale, score_dtype=score_dtype, bias=bias)
    raise ValueError(f"unknown attention impl {impl!r}")
