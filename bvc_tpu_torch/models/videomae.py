"""VideoMAE encoder for embedding extraction.

Counterpart of the encoder side of :mod:`bvc_tpu.models.videomae`
(``encode_visible``, ``normalize_on_device``, ``forward_features``,
``embed``): the patch embedding as one matrix product, the fixed 1-D
sinusoid position table, the pre-LN encoder blocks and the pooled
``LayerNorm(mean(tokens))`` embedding with unit affine, which is what
``VideoMAEForVideoClassification(num_labels=0)`` yields.  The decoder,
``patch_targets`` and ``pretrain_loss`` come with the training slice.

Parameter names: ``patch_embed.{weight,bias}`` (``nn.Linear`` layout,
``[D, C*ts*p*p]`` with the flat order (c, dt, dh, dw)) and
``blocks.layers.{i}.{ln1,qkv,proj,ln2,fc1,fc2}.{weight,bias}``;
:mod:`bvc_tpu_torch.models.convert` fills them from JAX params or an HF
state dict.
"""

from __future__ import annotations

import torch
from torch import nn

from bvc_tpu_torch.models.initializers import init_linear
from bvc_tpu_torch.models.posenc import sinusoid_table_1d
from bvc_tpu_torch.models.vit import Blocks, layer_norm
from bvc_tpu_torch.ops.patchify import patchify_pixels
from bvc_tpu_torch.utils.config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def normalize_on_device(video: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> ``(x/255 - 0.5) / 0.25`` in f32; other dtypes pass
    through unchanged (already normalized)."""
    if video.dtype == torch.uint8:
        return (video.float() * (1.0 / 255.0) - 0.5) * 4.0
    return video


class VideoMAEEncoder(nn.Module):
    """Patch embedding plus encoder blocks of VideoMAE.

    The methods' ``attn_impl`` is the attention routing of every block (see
    :func:`bvc_tpu_torch.ops.attention.multi_head_attention`).
    """

    def __init__(self, cfg: ModelConfig, seed: int = 0):
        super().__init__()
        if cfg.architecture != "base":
            raise ValueError(
                f"videomae architecture {cfg.architecture!r} is not defined; "
                "only 'base' exists (set explicit hidden_size/depth/... for "
                "custom sizes)")
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        patch_dim = cfg.in_channels * cfg.tubelet_size * cfg.patch_size ** 2
        self.patch_embed = nn.Linear(patch_dim, cfg.hidden_size)
        init_linear(self.patch_embed, cfg.init_std, gen)
        self.blocks = Blocks(cfg.depth, cfg.hidden_size, cfg.num_heads, cfg.mlp_ratio,
                             cfg.qkv_bias, cfg.layer_norm_eps, cfg.init_std, gen)
        self.register_buffer(
            "pos_embed",
            torch.from_numpy(sinusoid_table_1d(cfg.seq_len, cfg.hidden_size)),
            persistent=False)

    def encode_visible(self, video: torch.Tensor, visible_idx: torch.Tensor,
                       attn_impl: str = "auto") -> torch.Tensor:
        """Gather the pixel blocks of the ``visible_idx`` tokens (``[B, V]``),
        embed them, add their positions, run the encoder.  ``video`` is
        normalized ``[B, T, H, W, C]``.  Returns ``[B, V, D]``."""
        cfg = self.cfg
        dtype = _DTYPES[cfg.dtype]
        patches = patchify_pixels(video, cfg.tubelet_size, cfg.patch_size)
        idx = visible_idx[..., None]
        x = patches.gather(1, idx.expand(-1, -1, patches.shape[-1])).to(dtype)
        pe = self.patch_embed
        x = nn.functional.linear(x, pe.weight.to(dtype), pe.bias.to(dtype))
        pos = self.pos_embed.to(dtype).expand(x.shape[0], -1, -1)
        x = x + pos.gather(1, idx.expand(-1, -1, pos.shape[-1]))
        return self.blocks(x, attn_impl)

    def forward_features(self, video: torch.Tensor, attn_impl: str = "auto") -> torch.Tensor:
        """Unmasked encoder pass over all tokens, ``[B, N, D]``; ``video``
        may be uint8 (normalized here) or already normalized."""
        all_idx = torch.arange(self.cfg.seq_len, device=video.device)
        return self.encode_visible(normalize_on_device(video),
                                   all_idx.expand(video.shape[0], -1), attn_impl)

    def embed(self, video: torch.Tensor, attn_impl: str = "auto") -> torch.Tensor:
        """Pooled embedding ``[B, D]`` in f32: ``LayerNorm(mean(tokens))``
        with unit affine and eps 1e-6."""
        h = self.forward_features(video, attn_impl).float()
        return layer_norm(h.mean(dim=1), None, None, 1e-6)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        return self.embed(video)
