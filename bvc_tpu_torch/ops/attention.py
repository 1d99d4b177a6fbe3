"""Multi-head attention for the ViT stacks.

Counterpart of :mod:`bvc_tpu.ops.attention`.  Callers pass projected q, k,
v of shape ``[B, N, h, d]``.  Two implementations:

- :func:`plain_attention`, the counterpart of ``_xla_attention``: the
  attention written out in PyTorch, with the same dtype steps;
- :func:`bvc_tpu_torch.ops.flash_attention.flash_attention`: the CUDA kernel
  (its plain version for CPU tensors).
"""

from __future__ import annotations

import torch

from bvc_tpu_torch.ops.flash_attention import flash_attention

# 'auto' sends an unmasked bf16 CUDA attention of at least this many tokens
# to the flash kernel.  Set from the H100 timing of the kernel against
# plain_attention at [8, N, 12, 64], N in {160, 392, 784, 1568}
# (chip_smoke.py, PERF.md): the kernel won at every N measured, so the
# threshold is the smallest of them; shorter sequences stay unmeasured.
FLASH_MIN_TOKENS = 160


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, key_mask: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """f32 logits, times ``scale``, optional key-mask bias (``[B, N]`` bool,
    True = attendable; masked keys get -1e30), f32 softmax, probabilities
    cast to the input dtype, then P.V in the input dtype."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if key_mask is not None:
        bias = torch.where(key_mask[:, None, None, :], 0.0, -1e30)
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float | None = None, impl: str = "auto",
                         key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Scaled dot-product attention over ``[B, N, h, d]`` tensors.

    ``impl``: ``'auto'`` | ``'xla'`` (the plain math, under the JAX
    package's name) | ``'flash'``.  ``'flash'`` launches the kernel for CUDA
    tensors and runs its plain version for CPU tensors; it raises for a key
    mask (the key-bias kernels come with JEPA, ROADMAP slice 4) and, on
    CUDA, for anything but bf16 with head width 64.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "auto":
        # Routing rule, like the JAX package's N < 512 rule: f32 and masked
        # attention are plain math by design (the kernel is bf16 and has no
        # key bias yet), and so are sequences too short for the kernel to
        # beat the plain path on the card.
        use_flash = (q.is_cuda and q.dtype == torch.bfloat16 and key_mask is None
                     and q.shape[1] >= FLASH_MIN_TOKENS)
        impl = "flash" if use_flash else "xla"
    if impl == "flash":
        if key_mask is not None:
            raise NotImplementedError(
                "flash attention with a key mask: the key-bias kernels come "
                "with JEPA (ROADMAP slice 4)")
        return flash_attention(q, k, v, scale=scale)
    if impl == "xla":
        return plain_attention(q, k, v, scale, key_mask)
    raise ValueError(f"unknown attention impl {impl!r}")
