"""Image (2-D) ViT (counterpart of :mod:`bvc_tpu.models.vit_image`).

The reference's ``pretraining/predictive/vision_transformer_image.py``
(present there but not imported by its trainers): a standard image ViT with
the Conv2d patch embedding written as one matrix product over ``(c, dh,
dw)`` patches, the fixed 2-D sin-cos table (:func:`sincos_2d`), the port's
transformer core and a final LayerNorm.  Input at another resolution than
the configured one reads the table resized bicubically to its grid
(:func:`interpolate_pos_table`), as the reference does.  ``keep_idx``
(``[B, K]`` token indices, ``-1`` padded) keeps a subset of the tokens; its
``>= 0`` entries are the blocks' key mask, so on the card a masked forward
runs the key-bias attention kernels and an unmasked one the unmasked
kernels (``ops/attention.py``'s routing).

Parameter names: ``patch_embed.{weight,bias}`` (``nn.Linear`` layout,
``[D, C*p*p]``), ``blocks.layers.{i}.*`` and ``norm.{weight,bias}``,
filled from a JAX tree by
:func:`bvc_tpu_torch.models.convert.vit_image_from_jax_params`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bvc_tpu_torch.models.initializers import init_linear
from bvc_tpu_torch.models.jepa import safe_gather
from bvc_tpu_torch.models.posenc import interpolate_pos_table, sincos_2d
from bvc_tpu_torch.models.videomae import _DTYPES
from bvc_tpu_torch.models.vit import Blocks, LayerNorm
from bvc_tpu_torch.utils.config import ModelConfig


def patchify_image(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """``[B, H, W, C] -> [B, N, C*p*p]`` row-major patches, features in
    (c, dh, dw) order, the video patchify's convention."""
    B, H, W, C = images.shape
    p = patch_size
    x = images.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, (H // p) * (W // p), C * p * p)


class ImageViT(nn.Module):
    """Patch embedding, 2-D positions, blocks and the final norm; ``cfg``'s
    ``image_size``, ``patch_size``, ``in_channels``, widths and ``dtype``
    (``num_frames`` and ``tubelet_size`` are not read)."""

    def __init__(self, cfg: ModelConfig, seed: int = 0,
                 generator: torch.Generator | None = None):
        """Random weights drawn from ``generator``, or from a fresh one
        seeded with ``seed`` when it is None."""
        super().__init__()
        self.cfg = cfg
        gen = generator if generator is not None else torch.Generator().manual_seed(seed)
        self.patch_embed = nn.Linear(cfg.in_channels * cfg.patch_size ** 2, cfg.hidden_size)
        init_linear(self.patch_embed, cfg.init_std, gen)
        self.blocks = Blocks(cfg.depth, cfg.hidden_size, cfg.num_heads, cfg.mlp_ratio,
                             cfg.qkv_bias, cfg.layer_norm_eps, cfg.init_std, gen, cfg.remat)
        self.norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.register_buffer(
            "pos_embed",
            torch.from_numpy(sincos_2d(cfg.hidden_size, cfg.image_size // cfg.patch_size)),
            persistent=False)

    def forward(self, images: torch.Tensor, keep_idx: torch.Tensor | None = None,
                attn_impl: str = "auto") -> torch.Tensor:
        """``[B, H, W, C]`` images (taken as given, cast to the compute
        dtype) -> ``[B, N, D]``, or ``[B, K, D]`` at ``keep_idx``;
        final-normed, in the compute dtype."""
        dtype = _DTYPES[self.cfg.dtype]
        pe = self.patch_embed
        tokens = F.linear(patchify_image(images, self.cfg.patch_size).to(dtype),
                          pe.weight.to(dtype), pe.bias.to(dtype))
        pos = self.pos_embed
        if tokens.shape[1] != pos.shape[0]:
            pos = torch.from_numpy(interpolate_pos_table(pos.cpu().numpy(), tokens.shape[1])
                                   ).to(pos.device)
        tokens = tokens + pos.to(dtype)
        key_mask = None
        if keep_idx is not None:
            key_mask = keep_idx >= 0
            tokens = safe_gather(tokens, keep_idx)
        return self.norm(self.blocks(tokens, attn_impl, key_mask))

    def embed(self, images: torch.Tensor, attn_impl: str = "auto") -> torch.Tensor:
        """Mean over the tokens of the normed output, ``[B, D]`` in f32."""
        return self(images, attn_impl=attn_impl).float().mean(dim=1)
