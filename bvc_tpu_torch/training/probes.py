"""Gradient-health probes (counterpart of
:func:`bvc_tpu.training.probes.videomae_grad_metrics` and
:func:`~bvc_tpu.training.probes.jepa_grad_metrics`).

The reference's ``grad_logger`` reads the gradient norms of a few named
layers: three VideoMAE ones, or JEPA's first and last encoder ``qkv``
weights; the JAX package adds the global norm and takes them all from one
pass over the gradients.  So does this: one per-tensor norm per parameter
(``torch._foreach_norm``, one multi-tensor pass on the device), combined
into the metrics, which stay device tensors.
"""

from __future__ import annotations

import torch


def _grad_sumsqs(model: torch.nn.Module) -> list[tuple[str, torch.Tensor]]:
    """(name, squared gradient norm) of every parameter with a gradient."""
    named = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
    sumsq = [x.square() for x in torch._foreach_norm([g.float() for _, g in named])]
    return [(n, s) for (n, _), s in zip(named, sumsq)]


def videomae_grad_metrics(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """``grad_norm`` over every parameter with a gradient, and the norms of
    the patch embedding (``grad_efl``), the last encoder layer
    (``grad_ell``) and the decoder head (``grad_dll``) of a
    :class:`~bvc_tpu_torch.models.videomae.VideoMAEPretrain`."""
    last = f"encoder.blocks.layers.{len(model.encoder.blocks.layers) - 1}."
    parts = {"grad_norm": [], "grad_efl": [], "grad_ell": [], "grad_dll": []}
    for name, s in _grad_sumsqs(model):
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


def jepa_grad_metrics(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """``grad_norm`` over every parameter with a gradient, and the norms of
    the first (``grad_fl``) and last (``grad_ll``) encoder layer's ``qkv``
    weight of a :class:`~bvc_tpu_torch.models.jepa.JEPA`."""
    sumsqs = _grad_sumsqs(model)
    device = next(model.parameters()).device
    zero = torch.zeros((), device=device)
    last = len(model.encoder.blocks.layers) - 1
    by_name = dict(sumsqs)
    return {"grad_norm": torch.stack([s for _, s in sumsqs]).sum().sqrt() if sumsqs else zero,
            "grad_fl": by_name.get("encoder.blocks.layers.0.qkv.weight", zero).sqrt(),
            "grad_ll": by_name.get(f"encoder.blocks.layers.{last}.qkv.weight", zero).sqrt()}
