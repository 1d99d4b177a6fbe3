"""(V-)JEPA: the video ViT encoder and the narrow predictor.

Counterpart of :mod:`bvc_tpu.models.jepa` (``encoder_forward``,
``predictor_forward``, ``target_features``, ``embed``), on the port's
transformer core:

- masked token selection is an index gather with fixed caps plus attention
  key masks, as the JAX package does (see
  :mod:`bvc_tpu_torch.masks.multiblock`): indices are ``-1`` padded, the
  padding gathers token 0 and is made invisible by the key mask.  On the
  card the masked attention runs the key-bias flash kernels;
- the encoder's position table is the channel-split
  :func:`~bvc_tpu_torch.models.posenc.positional_encoding_3d`, the
  predictor has its own at its width;
- the encoder ends in a LayerNorm; the predictor embeds the context to
  ``pred_emb_dim``, appends mask tokens with the target positions' table
  entries, runs its blocks over [context ‖ mask tokens] with the
  concatenated key mask, norms, projects back to the encoder width and
  returns the mask tokens' outputs;
- several prediction masks are m-major: outputs and targets are stacked
  ``[M, B, K, D]`` in mask order.

Parameter names: the encoder's ``patch_embed.{weight,bias}`` (``nn.Linear``
layout, flat patch order (c, dt, dh, dw)), ``blocks.layers.{i}.*`` and
``norm.{weight,bias}``; the predictor's ``embed.*``, ``mask_token``
``[1, 1, Dp]``, ``blocks.layers.{i}.*``, ``norm.*`` and ``proj.*``;
:class:`JEPA` holds them under ``encoder.`` and ``predictor.``.
:mod:`bvc_tpu_torch.models.convert` fills them from JAX params, and the
encoder also from the reference layout of a ``.pth.tar``.

With ``cfg.pos_embed == 'rope3d'`` (V-JEPA 2, Assran et al. 2025) neither
network has a table: every block rotates its queries and keys by the
tokens' ids in the clip's grid (:mod:`bvc_tpu_torch.ops.rope`): the context
encoder's kept ids, the target's ``0 .. N-1``, the predictor's context ids
then its target ids; the mask tokens are the bare ``mask_token``.  The
predictor takes ``cfg.pred_num_heads`` heads and ``cfg.pred_mlp_ratio``
(each 0: the encoder's).

Drop-path (``cfg.drop_path_rate``, the reference's per-layer
``linspace(0, rate, depth)``) runs when the caller passes a generator, as
the JAX package's runs when it passes an rng: the training step passes its
state's.  Video at another spatial size than the configured one reads the
position table resized to its grid (``interpolate_pos_table_3d``), as the
JAX package's encoder does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bvc_tpu_torch.models.initializers import init_linear, trunc_normal_
from bvc_tpu_torch.models.posenc import interpolate_pos_table_3d, positional_encoding_3d
from bvc_tpu_torch.models.videomae import _DTYPES, normalize_on_device
from bvc_tpu_torch.models.vit import Blocks, LayerNorm, layer_norm
from bvc_tpu_torch.ops.patchify import tubelet_patchify
from bvc_tpu_torch.ops.rope import rope_positions
from bvc_tpu_torch.utils.config import ModelConfig


def _grid(cfg: ModelConfig) -> tuple[int, int, int]:
    g = cfg.image_size // cfg.patch_size
    return (cfg.num_frames // cfg.tubelet_size, g, g)


POS_EMBEDS = ("sincos3d", "rope3d")


def uses_rope(cfg: ModelConfig) -> bool:
    """Whether the configuration's JEPA networks take rotary positions;
    raises for an unknown ``pos_embed``."""
    if cfg.pos_embed not in POS_EMBEDS:
        raise ValueError(f"unknown pos_embed {cfg.pos_embed!r} (expected one of {POS_EMBEDS})")
    return cfg.pos_embed == "rope3d"


def safe_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x [B, N, D]`` at ``idx [B, K]`` -> ``[B, K, D]``, with ``-1``
    padding read as index 0 (the key mask hides those rows)."""
    return x.gather(1, idx.clamp(min=0)[..., None].expand(-1, -1, x.shape[-1]))


class JEPAEncoder(nn.Module):
    """Patch embedding, 3-D positions, encoder blocks and the final norm.

    ``attn_impl`` routes the attention of every block (see
    :func:`bvc_tpu_torch.ops.attention.multi_head_attention`)."""

    def __init__(self, cfg: ModelConfig, seed: int = 0,
                 generator: torch.Generator | None = None):
        """Random weights drawn from ``generator``, or from a fresh one
        seeded with ``seed`` when it is None."""
        super().__init__()
        self.cfg = cfg
        gen = generator if generator is not None else torch.Generator().manual_seed(seed)
        patch_dim = cfg.in_channels * cfg.tubelet_size * cfg.patch_size ** 2
        self.patch_embed = nn.Linear(patch_dim, cfg.hidden_size)
        init_linear(self.patch_embed, cfg.init_std, gen)
        self.rope = uses_rope(cfg)
        self.blocks = Blocks(cfg.depth, cfg.hidden_size, cfg.num_heads, cfg.mlp_ratio,
                             cfg.qkv_bias, cfg.layer_norm_eps, cfg.init_std, gen, cfg.remat,
                             _grid(cfg) if self.rope else None)
        self.norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        if not self.rope:
            self.register_buffer(
                "pos_embed",
                torch.from_numpy(positional_encoding_3d(*_grid(cfg), cfg.hidden_size)),
                persistent=False)

    def forward(self, video: torch.Tensor, keep_idx: torch.Tensor | None = None,
                attn_impl: str = "auto", generator: torch.Generator | None = None,
                token_offset: int | None = None) -> torch.Tensor:
        """Encode uint8 (normalized here) or normalized ``[B, T, H, W, C]``
        video.  ``keep_idx``: optional ``[B, K]`` token indices, ``-1``
        padded.  ``generator``: the drop-path draws (training; none without
        it).  ``token_offset``: the video is a time slice of the clip (a
        rank of a ``seq`` ring) whose first token sits there, and its
        tokens take the position table's rows from it; the slice must have
        the configured spatial size.  Returns ``[B, K, D]`` (``[B, N, D]``
        without ``keep_idx``), final-normed, in the compute dtype.  With
        rotary positions the video must have the configured grid, and a
        time slice is refused."""
        cfg = self.cfg
        dtype = _DTYPES[cfg.dtype]
        pe = self.patch_embed
        if self.rope:
            self._check_rope_input(video, token_offset)
            tokens = tubelet_patchify(normalize_on_device(video), pe.weight, pe.bias,
                                      cfg.tubelet_size, cfg.patch_size, dtype)
            ids = self.token_ids(keep_idx, tokens.shape[0], tokens.shape[1])
            return self._encode(tokens, keep_idx, attn_impl, generator, rope_positions(ids))
        t, h, w = _grid(cfg)
        t_in = video.shape[1] // cfg.tubelet_size
        h_in, w_in = video.shape[2] // cfg.patch_size, video.shape[3] // cfg.patch_size
        pos = self.pos_embed
        if token_offset is not None:
            if (h_in, w_in) != (h, w):
                raise ValueError(
                    f"a time slice of {h_in}x{w_in} patches: the sequence-parallel "
                    f"encoder reads the configured {h}x{w} grid's table (the resized "
                    "position table is not supported on a 'seq' mesh)")
            pos = pos[token_offset:token_offset + t_in * h * w]
        elif t_in != t:
            raise ValueError(f"time grid {t_in} != configured {t}: positional tables "
                             "only interpolate spatially")
        elif (h_in, w_in) != (h, w):
            pos = torch.from_numpy(interpolate_pos_table_3d(
                positional_encoding_3d(t, h, w, cfg.hidden_size), t, h, w, h_in, w_in)
            ).to(pos.device)
        tokens = tubelet_patchify(normalize_on_device(video), pe.weight, pe.bias,
                                  cfg.tubelet_size, cfg.patch_size, dtype)
        tokens = tokens + pos.to(dtype)
        return self._encode(tokens, keep_idx, attn_impl, generator)

    def _encode(self, tokens: torch.Tensor, keep_idx: torch.Tensor | None, attn_impl: str,
                generator: torch.Generator | None, pos: torch.Tensor | None = None
                ) -> torch.Tensor:
        key_mask = None
        if keep_idx is not None:
            key_mask = keep_idx >= 0
            tokens = safe_gather(tokens, keep_idx)
        return self.norm(self.blocks(tokens, attn_impl, key_mask, self.cfg.drop_path_rate,
                                     generator, pos))

    def token_ids(self, keep_idx: torch.Tensor | None, batch: int, n: int) -> torch.Tensor:
        """The rotary positions' token ids ``[B, K]`` of an encode: the kept
        ids, or ``0 .. n-1`` for every row without ``keep_idx``."""
        if keep_idx is not None:
            return keep_idx
        return torch.arange(n, device=self.patch_embed.weight.device).expand(batch, n)

    def _check_rope_input(self, video: torch.Tensor, token_offset: int | None) -> None:
        cfg = self.cfg
        if token_offset is not None:
            raise ValueError("pos_embed='rope3d' on a 'seq' mesh: the sequence-parallel "
                             "encoder passes its time slice a token offset into the position "
                             "table, and the rotary path has no table to offset (it takes "
                             "the clip's token ids); use a pure-data mesh")
        got = (video.shape[1] // cfg.tubelet_size, video.shape[2] // cfg.patch_size,
               video.shape[3] // cfg.patch_size)
        if got != _grid(cfg):
            raise ValueError(f"pos_embed='rope3d': the rotary tables are of the configured "
                             f"{_grid(cfg)} token grid, the video gives {got}")

    def embed(self, video: torch.Tensor, attn_impl: str = "auto") -> torch.Tensor:
        """Mean over the tokens of the normed encoder output, ``[B, D]`` in
        f32: the JEPA embedding extractor's pooling."""
        return self(video, attn_impl=attn_impl).float().mean(dim=1)


class JEPAPredictor(nn.Module):
    """The predictor: context features and target positions to predicted
    target features (``predictor_forward``)."""

    def __init__(self, cfg: ModelConfig, seed: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        gen = generator if generator is not None else torch.Generator().manual_seed(seed)
        d_enc, d_pred = cfg.hidden_size, cfg.pred_emb_dim
        self.embed = nn.Linear(d_enc, d_pred)
        init_linear(self.embed, cfg.init_std, gen)
        self.mask_token = nn.Parameter(torch.empty(1, 1, d_pred))
        trunc_normal_(self.mask_token, cfg.init_std, gen)
        self.rope = uses_rope(cfg)
        self.blocks = Blocks(cfg.pred_depth, d_pred, cfg.pred_num_heads or cfg.num_heads,
                             cfg.pred_mlp_ratio or cfg.mlp_ratio, cfg.qkv_bias,
                             cfg.layer_norm_eps, cfg.init_std, gen, cfg.remat,
                             _grid(cfg) if self.rope else None)
        self.norm = LayerNorm(d_pred, cfg.layer_norm_eps)
        self.proj = nn.Linear(d_pred, d_enc)
        init_linear(self.proj, cfg.init_std, gen)
        if not self.rope:
            self.register_buffer(
                "pos_embed", torch.from_numpy(positional_encoding_3d(*_grid(cfg), d_pred)),
                persistent=False)

    def forward(self, z: torch.Tensor, enc_idx: torch.Tensor, pred_idx: torch.Tensor,
                attn_impl: str = "auto", generator: torch.Generator | None = None
                ) -> torch.Tensor:
        """``z [B, Ke, D]``: encoder output at the context positions
        ``enc_idx [B, Ke]``; ``pred_idx [M, B, Kp]``: the target positions
        (both ``-1`` padded); ``generator``: the drop-path draws.  Returns
        ``[M, B, Kp, D]``."""
        dtype = z.dtype
        M, B, Kp = pred_idx.shape
        Ke = enc_idx.shape[1]
        x = F.linear(z, self.embed.weight.to(dtype), self.embed.bias.to(dtype))
        ids = None
        if self.rope:
            pred_tokens = self.mask_token.to(dtype).expand(M * B, Kp, -1)
            ids = rope_positions(torch.cat([enc_idx[None].expand(M, -1, -1).reshape(M * B, Ke),
                                            pred_idx.reshape(M * B, Kp)], dim=1))
        else:
            pos = self.pos_embed.to(dtype)
            x = x + pos[enc_idx.clamp(min=0)]
            pred_tokens = (self.mask_token.to(dtype)
                           + pos[pred_idx.clamp(min=0)].reshape(M * B, Kp, -1))
        # m-major tiling of the context, as x.repeat(len(masks), 1, 1)
        x = x[None].expand(M, -1, -1, -1).reshape(M * B, Ke, -1)
        enc_valid = (enc_idx >= 0)[None].expand(M, -1, -1).reshape(M * B, Ke)
        pred_valid = (pred_idx >= 0).reshape(M * B, Kp)
        full = self.blocks(torch.cat([x, pred_tokens], dim=1), attn_impl,
                           torch.cat([enc_valid, pred_valid], dim=1),
                           self.cfg.drop_path_rate, generator, ids)
        out = self.norm(full[:, Ke:])
        out = F.linear(out, self.proj.weight.to(dtype), self.proj.bias.to(dtype))
        return out.reshape(M, B, Kp, -1)


class JEPA(nn.Module):
    """The online networks of JEPA pretraining: ``encoder`` and
    ``predictor`` (the JAX package's ``{"encoder", "predictor"}`` tree).
    The EMA target encoder lives in the train state."""

    def __init__(self, cfg: ModelConfig, seed: int = 0):
        """Random weights from one generator seeded with ``seed``: the
        encoder's first (the same as ``JEPAEncoder(cfg, seed)``), then the
        predictor's."""
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.encoder = JEPAEncoder(cfg, generator=gen)
        self.predictor = JEPAPredictor(cfg, generator=gen)

    def forward(self, video: torch.Tensor, enc_idx: torch.Tensor, pred_idx: torch.Tensor,
                attn_impl: str = "auto", generator: torch.Generator | None = None
                ) -> torch.Tensor:
        """The predictor's features at the prediction positions ``pred_idx
        [M, B, Kp]`` from the context encoder's at ``enc_idx [B, Ke]``: the
        online half of the JEPA loss, what DistributedDataParallel calls."""
        z = self.encoder(video, enc_idx, attn_impl, generator)
        return self.predictor(z, enc_idx, pred_idx, attn_impl, generator)


@torch.no_grad()
def target_features(target: JEPAEncoder, video: torch.Tensor, pred_idx: torch.Tensor,
                    attn_impl: str) -> torch.Tensor:
    """Target features at the prediction positions ``pred_idx [M, B, Kp]``,
    ``[M, B, Kp, D]``, without a gradient: a full encode at ``attn_impl``,
    a parameterless f32 LayerNorm over the features (eps 1e-5), cast back,
    then the gather.  The caller picks ``attn_impl``: the JEPA step takes
    ``'xla_bf16'`` when ``cfg.target_score_bf16`` in bf16 (see
    :func:`~bvc_tpu_torch.training.steps.make_jepa_train_step`)."""
    h = layer_norm(target(video, attn_impl=attn_impl), None, None, 1e-5)
    M = pred_idx.shape[0]
    return torch.stack([safe_gather(h, pred_idx[m]) for m in range(M)])
