"""VideoMAE: the encoder for embedding extraction and the model for
masked pretraining.

Counterpart of :mod:`bvc_tpu.models.videomae`:

- :class:`VideoMAEEncoder` (``encode_visible``, ``normalize_on_device``,
  ``forward_features``, ``embed``): the patch embedding as one matrix
  product, the fixed 1-D sinusoid position table, the pre-LN encoder blocks
  and the pooled ``LayerNorm(mean(tokens))`` embedding with unit affine,
  which is what ``VideoMAEForVideoClassification(num_labels=0)`` yields;
- :class:`VideoMAEPretrain` (``init_params``, ``decode_masked``,
  ``pretrain_loss``): the encoder on the visible tokens, ``enc_to_dec``
  (no bias), the mask token, the decoder blocks over [visible ‖ mask
  tokens] with the decoder's sinusoid positions, the decoder norm and the
  head on the masked tokens, and the norm-pix MSE against
  :func:`patch_targets` (HF semantics: with mean pooling the encoder output
  is not layer-normed before ``enc_to_dec``).

Parameter names of the encoder: ``patch_embed.{weight,bias}``
(``nn.Linear`` layout, ``[D, C*ts*p*p]`` with the flat order
(c, dt, dh, dw)) and ``blocks.layers.{i}.{ln1,qkv,proj,ln2,fc1,fc2}.
{weight,bias}``.  The pretraining model holds the encoder under
``encoder.`` and adds ``enc_to_dec.weight`` ``[Dd, D]``, ``mask_token``
``[1, 1, Dd]``, ``decoder.layers.{i}.*`` (the encoder's block names),
``decoder_norm.{weight,bias}`` and ``decoder_head.{weight,bias}``
``[C*ts*p*p, Dd]`` whose outputs are in (pixel, channel) order.
:mod:`bvc_tpu_torch.models.convert` fills them from JAX params, and the
encoder also from an HF state dict.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bvc_tpu_torch.masks.tube import mask_partition
from bvc_tpu_torch.models.initializers import init_linear, trunc_normal_
from bvc_tpu_torch.models.posenc import sinusoid_table_1d
from bvc_tpu_torch.models.vit import Blocks, LayerNorm, layer_norm
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
    :func:`bvc_tpu_torch.ops.attention.multi_head_attention`).  Their
    ``token_offset`` is the position of the video's first token in the
    whole clip: a rank of a ``seq`` ring holds a slice of the time axis,
    whose tokens are the position table's rows from that offset on
    (:mod:`bvc_tpu_torch.parallel.seqpar`).
    """

    def __init__(self, cfg: ModelConfig, seed: int = 0,
                 generator: torch.Generator | None = None):
        """Random weights drawn from ``generator``, or from a fresh one
        seeded with ``seed`` when it is None."""
        super().__init__()
        if cfg.architecture != "base":
            raise ValueError(
                f"videomae architecture {cfg.architecture!r} is not defined; "
                "only 'base' exists (set explicit hidden_size/depth/... for "
                "custom sizes)")
        if cfg.pos_embed != "sincos3d":
            raise ValueError(f"pos_embed={cfg.pos_embed!r}: VideoMAE adds its fixed sinusoid "
                             "table; rotary positions ('rope3d') are a JEPA option")
        self.cfg = cfg
        gen = generator if generator is not None else torch.Generator().manual_seed(seed)
        patch_dim = cfg.in_channels * cfg.tubelet_size * cfg.patch_size ** 2
        self.patch_embed = nn.Linear(patch_dim, cfg.hidden_size)
        init_linear(self.patch_embed, cfg.init_std, gen)
        self.blocks = Blocks(cfg.depth, cfg.hidden_size, cfg.num_heads, cfg.mlp_ratio,
                             cfg.qkv_bias, cfg.layer_norm_eps, cfg.init_std, gen, cfg.remat)
        self.register_buffer(
            "pos_embed",
            torch.from_numpy(sinusoid_table_1d(cfg.seq_len, cfg.hidden_size)),
            persistent=False)

    def encode_visible(self, video: torch.Tensor, visible_idx: torch.Tensor,
                       attn_impl: str = "auto", token_offset: int = 0) -> torch.Tensor:
        """Gather the pixel blocks of the ``visible_idx`` tokens (``[B, V]``),
        embed them, add their positions, run the encoder.  ``video`` is
        normalized ``[B, T, H, W, C]``.  Returns ``[B, V, D]``."""
        return self.blocks(self.embed_visible(video, visible_idx, token_offset), attn_impl)

    def embed_visible(self, video: torch.Tensor, visible_idx: torch.Tensor,
                      token_offset: int = 0) -> torch.Tensor:
        """The encoder's input ``[B, V, D]``: :meth:`encode_visible` up to
        its blocks (a pipeline's first stage runs it,
        :mod:`bvc_tpu_torch.parallel.pipeline`)."""
        cfg = self.cfg
        dtype = _DTYPES[cfg.dtype]
        patches = patchify_pixels(video, cfg.tubelet_size, cfg.patch_size)
        idx = visible_idx[..., None]
        x = patches.gather(1, idx.expand(-1, -1, patches.shape[-1])).to(dtype)
        pe = self.patch_embed
        x = nn.functional.linear(x, pe.weight.to(dtype), pe.bias.to(dtype))
        pos = self.pos_embed[token_offset:token_offset + patches.shape[1]].to(dtype)
        pos = pos.expand(x.shape[0], -1, -1)
        return x + pos.gather(1, idx.expand(-1, -1, pos.shape[-1]))

    def forward_features(self, video: torch.Tensor, attn_impl: str = "auto",
                         token_offset: int = 0) -> torch.Tensor:
        """Unmasked encoder pass over all tokens, ``[B, N, D]``; ``video``
        may be uint8 (normalized here) or already normalized."""
        cfg = self.cfg
        n = (video.shape[1] // cfg.tubelet_size) * (video.shape[2] // cfg.patch_size) * (
            video.shape[3] // cfg.patch_size)
        all_idx = torch.arange(n, device=video.device)
        return self.encode_visible(normalize_on_device(video),
                                   all_idx.expand(video.shape[0], -1), attn_impl, token_offset)

    def embed(self, video: torch.Tensor, attn_impl: str = "auto") -> torch.Tensor:
        """Pooled embedding ``[B, D]`` in f32: ``LayerNorm(mean(tokens))``
        with unit affine and eps 1e-6."""
        h = self.forward_features(video, attn_impl).float()
        return layer_norm(h.mean(dim=1), None, None, 1e-6)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        return self.embed(video)


def patch_targets(video: torch.Tensor, cfg: ModelConfig,
                  idx: torch.Tensor | None = None) -> torch.Tensor:
    """Norm-pix regression targets ``[B, N|K, ts*p*p*C]`` in f32 from
    normalized video: each patch normalized per channel over its ts*p*p
    pixels with the unbiased variance and eps added to the std, features in
    (pixel, channel) order (HF).  ``idx`` (``[B, K]``) picks patches first,
    which is exact since the normalisation is per patch."""
    B, C = video.shape[0], video.shape[-1]
    q = cfg.tubelet_size * cfg.patch_size ** 2
    x = patchify_pixels(video, cfg.tubelet_size, cfg.patch_size).float()
    if idx is not None:
        x = x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))
    x = x.reshape(B, x.shape[1], C, q)
    if cfg.norm_pix_loss:
        mean = x.mean(dim=3, keepdim=True)
        std = x.var(dim=3, unbiased=True, keepdim=True).sqrt()
        x = (x - mean) / (std + 1e-6)
    return x.transpose(2, 3).reshape(B, x.shape[1], q * C)


class VideoMAEPretrain(nn.Module):
    """VideoMAE for masked pretraining: :class:`VideoMAEEncoder` plus the
    decoder side.  The methods' ``attn_impl`` is the attention routing of
    every block, encoder and decoder, and their ``token_offset`` the
    position of the video's first token in the whole clip (see
    :class:`VideoMAEEncoder`)."""

    def __init__(self, cfg: ModelConfig, seed: int = 0):
        """Random weights from one generator seeded with ``seed``: the
        encoder's first (the same as ``VideoMAEEncoder(cfg, seed)``), then
        the decoder's."""
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.encoder = VideoMAEEncoder(cfg, generator=gen)
        enc_d, dec_d = cfg.hidden_size, cfg.decoder_hidden_size
        patch_dim = cfg.in_channels * cfg.tubelet_size * cfg.patch_size ** 2
        self.enc_to_dec = nn.Linear(enc_d, dec_d, bias=False)
        init_linear(self.enc_to_dec, cfg.init_std, gen)
        self.mask_token = nn.Parameter(torch.empty(1, 1, dec_d))
        trunc_normal_(self.mask_token, cfg.init_std, gen)
        self.decoder = Blocks(cfg.decoder_depth, dec_d, cfg.decoder_num_heads, cfg.mlp_ratio,
                              cfg.qkv_bias, cfg.layer_norm_eps, cfg.init_std, gen, cfg.remat)
        self.decoder_norm = LayerNorm(dec_d, cfg.layer_norm_eps)
        self.decoder_head = nn.Linear(dec_d, patch_dim)
        init_linear(self.decoder_head, cfg.init_std, gen)
        self.register_buffer(
            "decoder_pos_embed",
            torch.from_numpy(sinusoid_table_1d(cfg.seq_len, dec_d)), persistent=False)

    def decode_masked(self, encoded: torch.Tensor, visible_idx: torch.Tensor,
                      masked_idx: torch.Tensor, attn_impl: str = "auto",
                      token_offset: int = 0) -> torch.Tensor:
        """Pixel predictions of the masked tokens, ``[B, M, C*ts*p*p]``, from
        the encoder output ``[B, V, D]``."""
        x = self.bridge(encoded, visible_idx, masked_idx, token_offset)
        return self.predict(self.decoder(x, attn_impl), masked_idx.shape[1])

    def bridge(self, encoded: torch.Tensor, visible_idx: torch.Tensor,
               masked_idx: torch.Tensor, token_offset: int = 0) -> torch.Tensor:
        """The decoder's input ``[B, V + M, Dd]``: the encoder output taken
        to the decoder's width, then the mask tokens, each with its
        decoder position (:meth:`decode_masked` up to its blocks)."""
        dtype = encoded.dtype
        n = visible_idx.shape[1] + masked_idx.shape[1]
        pos = self.decoder_pos_embed[token_offset:token_offset + n].to(dtype)
        z = F.linear(encoded, self.enc_to_dec.weight.to(dtype))
        return torch.cat([z + pos[visible_idx],
                          self.mask_token.to(dtype) + pos[masked_idx]], dim=1)

    def predict(self, decoded: torch.Tensor, n_masked: int) -> torch.Tensor:
        """The decoder norm and head on the last ``n_masked`` tokens of the
        decoder's output (:meth:`decode_masked` after its blocks)."""
        x = self.decoder_norm(decoded[:, -n_masked:])
        head = self.decoder_head
        return F.linear(x, head.weight.to(decoded.dtype), head.bias.to(decoded.dtype))

    def pretrain_loss(self, video: torch.Tensor, mask: torch.Tensor, num_visible: int,
                      attn_impl: str = "auto", token_offset: int = 0) -> torch.Tensor:
        """Masked reconstruction loss, a scalar f32 tensor: the mean squared
        error of the masked tokens' predictions against their norm-pix
        targets.  ``video`` is uint8 (normalized here) or normalized
        ``[B, T, H, W, C]``; ``mask`` ``[B, N]`` bool, True = masked, with
        ``num_visible`` False entries in every row.  On a rank of a ``seq``
        ring, ``video`` and ``mask`` are its time slice, ``token_offset``
        its first token, and the loss its tokens' mean."""
        video = normalize_on_device(video)
        visible_idx, masked_idx = mask_partition(mask, num_visible)
        encoded = self.encoder.encode_visible(video, visible_idx, attn_impl, token_offset)
        preds = self.decode_masked(encoded, visible_idx, masked_idx, attn_impl, token_offset)
        targets = patch_targets(video, self.cfg, masked_idx)
        return (preds.float() - targets).square().mean()

    forward = pretrain_loss  # what DistributedDataParallel calls
