"""Gradient-health probes (counterpart of
:func:`bvc_tpu.training.probes.videomae_grad_metrics`).

The reference's generative ``grad_logger`` reads the gradient norms of three
named VideoMAE layers; the JAX package adds the global norm and takes all
four from one pass over the gradients.  So does this: one per-tensor norm
per parameter (``torch._foreach_norm``, one multi-tensor pass on the
device), combined into the four metrics, which stay device tensors.
"""

from __future__ import annotations

import torch


def videomae_grad_metrics(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """``grad_norm`` over every parameter with a gradient, and the norms of
    the patch embedding (``grad_efl``), the last encoder layer
    (``grad_ell``) and the decoder head (``grad_dll``) of a
    :class:`~bvc_tpu_torch.models.videomae.VideoMAEPretrain`."""
    named = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
    sumsq = [x.square() for x in torch._foreach_norm([g.float() for _, g in named])]
    last = f"encoder.blocks.layers.{len(model.encoder.blocks.layers) - 1}."
    parts = {"grad_norm": [], "grad_efl": [], "grad_ell": [], "grad_dll": []}
    for (name, _), s in zip(named, sumsq):
        parts["grad_norm"].append(s)
        if name.startswith("encoder.patch_embed."):
            parts["grad_efl"].append(s)
        elif name.startswith(last):
            parts["grad_ell"].append(s)
        elif name.startswith("decoder_head."):
            parts["grad_dll"].append(s)
    device = next(model.parameters()).device
    return {k: torch.stack(v).sum().sqrt() if v else torch.zeros((), device=device)
            for k, v in parts.items()}
