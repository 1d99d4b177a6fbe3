"""Hiera video MAE (Ryali et al. 2023, arXiv:2306.00989; the reference code's
``hiera.py`` and ``hiera_mae.py``, preset ``mae_hiera_huge_16x224``).

A hierarchical encoder on VideoMAE's pretraining path
(:func:`~bvc_tpu_torch.training.steps.make_videomae_train_step` calls
:meth:`HieraMAE.forward` as it calls ``VideoMAEPretrain``'s):

- Patch embedding: a Conv3d (kernel ``patch_kernel``, stride
  ``(tubelet_size, patch_size, patch_size)``, padding ``patch_padding``)
  over the normalized clip times the mask of kept units, each unit's mask
  spread over its pixels (the "masked conv": no masked pixel reaches a kept
  token), plus the spatial table repeated over time and the temporal table
  repeated over space (the video presets' separate tables).
- :func:`unroll` reorders the tokens by the query stride, once a pooling
  level: after it the unit index is innermost, so a unit's tokens are
  ``x.view(B, -1, units, C)`` and a 2 x 2 max pool is
  ``x.view(B, 4, -1, C).max(1)``.  A mask drops whole units (a gather over
  the unit index).
- Stages of :class:`HieraBlock`: the width grows by ``dim_mul`` at each
  stage's first block (``dim_proj``), where the queries and the residual
  pool (the first ``q_pool`` such blocks); mask-unit attention
  (:func:`mask_unit_attention`) in the stages ``mask_unit_attn`` names and
  in the next stage's first block, global attention in the others.
- Multi-scale fusion (MAE): the outputs of the first ``q_pool`` stages and
  of the last, rerolled to ``[B, units, *unit, C]`` (:func:`reroll`),
  summed after Conv3d heads whose kernel equals their stride (run as one
  product: :func:`fuse`), then the encoder norm.
- Decoder: the fused tokens to the decoder's width, mask tokens in the
  dropped units, :func:`undo_windowing` to the raster order, a learned
  position table, the ViT blocks of :mod:`~bvc_tpu_torch.models.vit` (their
  attention through :func:`~bvc_tpu_torch.ops.attention.multi_head_attention`),
  the decoder norm and head on the masked units' tokens.
- Loss: the mean squared error against every ``tubelet_size``-th frame's
  patches of the decoder's stride, (y, x, channel) order, each normalized by
  its mean and ``(var_unbiased + 1e-6) ** 0.5``.

Layout steps are views, permutes and gathers.  The dtype policy is the
ViT's (:mod:`~bvc_tpu_torch.models.vit`): f32 parameters, activations in
``cfg.dtype``, LayerNorm statistics and softmax in f32.

Names: ``encoder.patch_embed.{weight,bias}`` (Conv3d layout),
``encoder.pos_embed_spatial``, ``encoder.pos_embed_temporal``,
``encoder.blocks.layers.{i}.{ln1,dim_proj,qkv,proj,ln2,fc1,fc2}.*``, ``fusion.{i}.{weight,bias}`` (Conv3d layout), ``norm``,
``decoder_embed``, ``mask_token``, ``decoder_pos_embed``,
``decoder.layers.{i}.*``, ``decoder_norm``, ``decoder_head``.

Spans: a ``bvc::mask_unit_attn`` range over each mask-unit attention (q
pool, window permutes and attention), forward and backward; a
``bvc::hiera.fusion`` range over the reroll, the fusion heads and the
decoder's fill.  Counter: ``mask_unit_attention.windows``, the windows
attended.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from bvc_tpu_torch.masks.tube import mask_partition
from bvc_tpu_torch.models.initializers import init_linear, trunc_normal_
from bvc_tpu_torch.models.videomae import normalize_on_device
from bvc_tpu_torch.models.vit import Blocks, LayerNorm, _dense, layer_norm
from bvc_tpu_torch.ops.attention import multi_head_attention
from bvc_tpu_torch.ops.gelu import gelu
from bvc_tpu_torch.utils.config import ModelConfig
from bvc_tpu_torch.utils.profiling import profiler_range

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# Hiera-H video MAE at 16 x 224 (mae_hiera_huge_16x224): what the VideoMAE
# CLI's --architecture hiera starts from
HIERA_H = {"hidden_size": 256, "patch_size": 4, "tubelet_size": 2,
           "stage_depths": (2, 6, 36, 4), "stage_heads": (4, 8, 16, 32), "dim_mul": 2.0,
           "q_pool": 2, "q_stride": (1, 2, 2), "mask_unit_size": (1, 8, 8),
           "mask_unit_attn": (True, True, False, False), "patch_kernel": (3, 7, 7),
           "patch_padding": (1, 3, 3), "mlp_ratio": 4.0,
           "decoder_hidden_size": 512, "decoder_depth": 8, "decoder_num_heads": 16,
           "layer_norm_eps": 1e-6}


def token_grid(cfg: ModelConfig) -> tuple[int, int, int]:
    """``(T, H, W)`` of the patch embedding's output."""
    return (cfg.num_frames // cfg.tubelet_size, cfg.image_size // cfg.patch_size,
            cfg.image_size // cfg.patch_size)


def unit_grid(cfg: ModelConfig) -> tuple[int, int, int]:
    """``(T, H, W)`` of the mask units."""
    return tuple(g // u for g, u in zip(token_grid(cfg), cfg.mask_unit_size))


def stage_widths(cfg: ModelConfig) -> list[int]:
    return [int(cfg.hidden_size * cfg.dim_mul ** i) for i in range(len(cfg.stage_depths))]


def decoder_grid(cfg: ModelConfig) -> tuple[int, int, int]:
    """``(T, H, W)`` of the decoder's tokens: the token grid over the pooled
    strides."""
    pooled = [s ** cfg.q_pool for s in cfg.q_stride]
    return tuple(g // p for g, p in zip(token_grid(cfg), pooled))


def pred_stride(cfg: ModelConfig) -> int:
    """Pixels a side of a decoder token's patch."""
    return cfg.patch_size * cfg.q_stride[-1] ** cfg.q_pool


def unroll(x: torch.Tensor, size: tuple[int, ...], schedule: list[tuple[int, ...]]
           ) -> torch.Tensor:
    """``[B, N, C]`` tokens in raster order of ``size`` to Hiera's unrolled
    order: each axis's index split as ``((q s_k + d_k) ... ) s_1 + d_1`` by
    the ``k`` strides of ``schedule``; the tokens ordered by ``(d_1, d_2,
    ..., d_k, q)``, each group over the axes, so the strides of the first
    unroll are outermost and the coarse grid ``q`` innermost.  One permute
    (the reference code's ``Unroll`` applies the strides one at a time, to
    the same order)."""
    B, N, C = x.shape
    nd, k = len(size), len(schedule)
    coarse = [n // math.prod(s[a] for s in schedule) for a, n in enumerate(size)]
    # each axis viewed as [q, d_k, ..., d_1]
    shape = [B]
    for a in range(nd):
        shape += [coarse[a]] + [schedule[j][a] for j in reversed(range(k))]
    x = x.view(*shape, C)
    per_axis = k + 1
    axis_dim = [1 + a * per_axis for a in range(nd)]  # where each axis's q sits
    order = [0]
    for j in range(k):  # d_1 first: at offset k - j after its axis's q
        order += [axis_dim[a] + (k - j) for a in range(nd)]
    order += axis_dim + [len(shape)]
    return x.permute(order).reshape(B, N, C)


def reroll(x: torch.Tensor, units: int, schedule: list[tuple[int, ...]]) -> torch.Tensor:
    """Unrolled ``[B, N, C]`` tokens of ``units`` units (the coarse grid,
    innermost) to ``[B, units, *unit, C]``, each unit's tokens in raster
    order, for the strides ``schedule`` still unrolled: within a unit, an
    axis's offset is ``(d_k s_{k-1} + ... ) s_1 + d_1``."""
    B, N, C = x.shape
    nd, k = len(schedule[0]), len(schedule)
    x = x.view(B, *[s for strides in schedule for s in strides], units, C)
    order = [0, 1 + nd * k]
    for a in range(nd):
        order += [1 + j * nd + a for j in reversed(range(k))]
    unit = [math.prod(s[a] for s in schedule) for a in range(nd)]
    return x.permute(*order, 2 + nd * k).reshape(B, units, *unit, C)


def undo_windowing(x: torch.Tensor, grid: tuple[int, ...], unit: tuple[int, ...]
                   ) -> torch.Tensor:
    """``[B, units, *unit, C]`` (the units in raster order of ``grid``, the
    unit grid) to ``[B, *(grid * unit), C]`` in raster order."""
    B, C, nd = x.shape[0], x.shape[-1], len(grid)
    x = x.view(B, *grid, *unit, C)
    order = [0] + [i for a in range(nd) for i in (1 + a, 1 + nd + a)] + [1 + 2 * nd]
    return x.permute(order).reshape(B, *[g * u for g, u in zip(grid, unit)], C)


def pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Hiera's max pool of unrolled tokens: the max over the ``stride``
    leading chunks of dimension 1 (each chunk a stride offset of the first
    unroll still in place)."""
    return x.unflatten(1, (stride, -1)).max(dim=1).values


class _BackwardRange(torch.autograd.Function):
    """The identity; its backward opens (``opens``) or closes the profiler
    range ``name`` held in ``box``, so that the gradient operations between
    the two marks of one call run inside the range."""

    @staticmethod
    def forward(ctx, x, name: str, opens: bool, box: list):
        ctx.name, ctx.opens, ctx.box = name, opens, box
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.opens:
            rng = profiler_range(ctx.name)
            rng.__enter__()
            ctx.box.append(rng)
        elif ctx.box:
            ctx.box.pop().__exit__(None, None, None)
        return g, None, None, None


def mask_unit_attention(qkv: torch.Tensor, heads: int, windows: int, q_stride: int,
                        attn_impl: str = "auto") -> torch.Tensor:
    """Attention within each of ``windows`` windows of Hiera's unrolled
    tokens: ``qkv [B, N, 3 D]`` (token ``j windows + w`` is token ``j`` of
    window ``w``), q max-pooled over its ``q_stride`` leading chunks, then
    :func:`~bvc_tpu_torch.ops.attention.multi_head_attention` on ``[B
    windows, N / windows, heads, D / heads]`` (queries at their pooled
    length); returns ``[B, N / q_stride, D]`` in the same order.  One
    window is global attention.  Inside a ``bvc::mask_unit_attn`` range,
    forward and backward, with the windows counted in
    ``mask_unit_attention.windows``."""
    B, N, D3 = qkv.shape
    D = D3 // 3
    hd, tokens = D // heads, N // windows
    box: list = []
    if qkv.requires_grad:
        qkv = _BackwardRange.apply(qkv, "mask_unit_attn", False, box)
    with profiler_range("mask_unit_attn"):
        q, k, v = qkv.view(B, tokens, windows, 3, heads, hd).unbind(3)
        if q_stride > 1:
            q = pool(q, q_stride)
        q, k, v = (t.transpose(1, 2).reshape(B * windows, t.shape[1], heads, hd)
                   for t in (q, k, v))
        o = multi_head_attention(q, k, v, impl=attn_impl)
        nq = o.shape[1]
        o = o.reshape(B, windows, nq, D).transpose(1, 2).reshape(B, nq * windows, D)
    mask_unit_attention.windows += B * windows
    if o.requires_grad:
        o = _BackwardRange.apply(o, "mask_unit_attn", True, box)
    return o


mask_unit_attention.windows = 0


def global_attention(qkv: torch.Tensor, heads: int, q_stride: int,
                     attn_impl: str = "auto") -> torch.Tensor:
    """Attention over all ``[B, N, 3 D]`` tokens (one window), q max-pooled
    over its ``q_stride`` leading chunks; ``[B, N / q_stride, D]``."""
    B, N, D3 = qkv.shape
    D = D3 // 3
    q, k, v = qkv.view(B, N, 3, heads, D // heads).unbind(2)
    if q_stride > 1:
        q = pool(q, q_stride)
    o = multi_head_attention(q, k, v, impl=attn_impl)
    return o.reshape(B, o.shape[1], D)


class HieraBlock(nn.Module):
    """Hiera's block on unrolled ``[B, N, D]`` tokens: ``h = ln1(x)``; where
    the width changes ``x = pool(dim_proj(h))`` (the pool only where the
    queries pool); ``x + proj(attn(h))``; ``x + fc2(gelu(fc1(ln2(x))))``.
    The attention is mask-unit attention over ``N / (q_stride window)``
    windows where ``mask_unit``, global otherwise."""

    shard_unit = True  # FSDP2 shards the model block by block

    def __init__(self, dim: int, dim_out: int, heads: int, q_stride: int, window: int,
                 mask_unit: bool, mlp_ratio: float, qkv_bias: bool, ln_eps: float,
                 init_std: float, generator: torch.Generator):
        super().__init__()
        self.num_heads, self.q_stride, self.window, self.mask_unit = (
            heads, q_stride, window, mask_unit)
        self.ln1 = LayerNorm(dim, ln_eps)
        self.dim_proj = nn.Linear(dim, dim_out) if dim != dim_out else None
        self.qkv = nn.Linear(dim, 3 * dim_out, bias=qkv_bias)
        self.proj = nn.Linear(dim_out, dim_out)
        self.ln2 = LayerNorm(dim_out, ln_eps)
        self.fc1 = nn.Linear(dim_out, int(dim_out * mlp_ratio))
        self.fc2 = nn.Linear(int(dim_out * mlp_ratio), dim_out)
        for layer in (self.dim_proj, self.qkv, self.proj, self.fc1, self.fc2):
            if layer is not None:
                init_linear(layer, init_std, generator)

    def forward(self, x: torch.Tensor, attn_impl: str = "auto") -> torch.Tensor:
        B, N, _ = x.shape
        h = self.ln1(x)
        if self.dim_proj is not None:
            x = _dense(h, self.dim_proj)
            if self.q_stride > 1:
                x = pool(x, self.q_stride)
        qkv = _dense(h, self.qkv)
        if self.mask_unit:
            windows = N // (self.q_stride * self.window)
            attn = mask_unit_attention(qkv, self.num_heads, windows, self.q_stride, attn_impl)
        else:
            attn = global_attention(qkv, self.num_heads, self.q_stride, attn_impl)
        x = x + _dense(attn, self.proj)
        return x + _dense(gelu(_dense(self.ln2(x), self.fc1)), self.fc2)


class HieraStack(nn.Module):
    """The encoder's blocks in order (``layers``), each stage's last block
    listed in ``stage_ends``; ``remat`` recomputes each block's activations
    in the backward."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        widths = stage_widths(cfg)
        depths = list(cfg.stage_depths)
        self.stage_ends = [sum(depths[:i + 1]) - 1 for i in range(len(depths))]
        self.remat = cfg.remat
        q_area = math.prod(cfg.q_stride)
        mu_area = math.prod(cfg.mask_unit_size)
        layers, dim = [], cfg.hidden_size
        for s, depth in enumerate(depths):
            mu = cfg.mask_unit_attn[s]
            lag = cfg.mask_unit_attn[s - 1] if s > 0 else False
            window = mu_area // q_area ** s
            for i in range(depth):
                pools = i == 0 and 0 < s <= cfg.q_pool
                layers.append(HieraBlock(
                    dim, widths[s], cfg.stage_heads[s], q_area if pools else 1, window,
                    mu or (lag and i == 0), cfg.mlp_ratio, cfg.qkv_bias, cfg.layer_norm_eps,
                    cfg.init_std, generator))
                dim = widths[s]
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, attn_impl: str = "auto") -> list[torch.Tensor]:
        """Each stage's output, in order."""
        outs = []
        remat = self.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x = torch.utils.checkpoint.checkpoint(layer, x, attn_impl, use_reentrant=False,
                                                      preserve_rng_state=False)
            else:
                x = layer(x, attn_impl)
            if i in self.stage_ends:
                outs.append(x)
        return outs


class HieraEncoder(nn.Module):
    """Hiera's patch embedding, position tables and blocks; the embedding of
    extraction (:meth:`embed`)."""

    def __init__(self, cfg: ModelConfig, seed: int = 0,
                 generator: torch.Generator | None = None):
        """Random weights drawn from ``generator``, or from a fresh one
        seeded with ``seed`` when it is None."""
        super().__init__()
        if cfg.architecture != "hiera" or not cfg.stage_depths:
            raise ValueError("HieraEncoder needs architecture 'hiera' and stage_depths")
        if len(cfg.stage_heads) != len(cfg.stage_depths) or len(
                cfg.mask_unit_attn) != len(cfg.stage_depths):
            raise ValueError("stage_depths, stage_heads and mask_unit_attn name the same stages")
        unrolled = [s ** (len(cfg.stage_depths) - 1) for s in cfg.q_stride]
        if list(cfg.mask_unit_size) != unrolled:
            raise ValueError(f"mask_unit_size {tuple(cfg.mask_unit_size)} must be q_stride to the "
                             f"power of the stages less one, {tuple(unrolled)}: a unit's tokens "
                             "are the strides the unroll moves out")
        self.cfg = cfg
        gen = generator if generator is not None else torch.Generator().manual_seed(seed)
        self.feature_dim = stage_widths(cfg)[-1]
        C = cfg.hidden_size
        stride = (cfg.tubelet_size, cfg.patch_size, cfg.patch_size)
        self.patch_embed = nn.Conv3d(cfg.in_channels, C, tuple(cfg.patch_kernel), stride,
                                     tuple(cfg.patch_padding))
        trunc_normal_(self.patch_embed.weight, cfg.init_std, gen)
        nn.init.zeros_(self.patch_embed.bias)
        T, H, W = token_grid(cfg)
        self.pos_embed_spatial = nn.Parameter(torch.empty(1, H * W, C))
        self.pos_embed_temporal = nn.Parameter(torch.empty(1, T, C))
        for t in (self.pos_embed_spatial, self.pos_embed_temporal):
            trunc_normal_(t, cfg.init_std, gen)
        self.blocks = HieraStack(cfg, gen)

    def schedule(self, stage: int) -> list[tuple[int, ...]]:
        """The unroll strides still unrolled at ``stage``'s output."""
        k = len(self.cfg.stage_depths) - 1
        return [tuple(self.cfg.q_stride)] * (k - min(stage, self.cfg.q_pool))

    def tokens(self, video: torch.Tensor, keep_idx: torch.Tensor | None) -> torch.Tensor:
        """Normalized ``[B, T, H, W, C]`` clips to the unrolled tokens of the
        kept units (``keep_idx [B, K]``, ascending; every unit where None):
        the masked conv, the position tables, :func:`unroll`, the drop."""
        cfg = self.cfg
        dtype = _DTYPES[cfg.dtype]
        B = video.shape[0]
        units = unit_grid(cfg)
        n_units = math.prod(units)
        x = video.to(dtype)
        if keep_idx is not None:  # every masked unit's pixels to zero
            keep = torch.zeros((B, n_units), dtype=dtype, device=video.device)
            keep.scatter_(1, keep_idx, 1.0)
            T, H, W, C = x.shape[1:]
            px = [n // u for n, u in zip((T, H, W), units)]
            x = (x.view(B, units[0], px[0], units[1], px[1], units[2], px[2], C)
                 * keep.view(B, units[0], 1, units[1], 1, units[2], 1, 1)).view(B, T, H, W, C)
        pe = self.patch_embed
        x = F.conv3d(x.permute(0, 4, 1, 2, 3), pe.weight.to(dtype), pe.bias.to(dtype),
                     pe.stride, pe.padding)
        x = x.flatten(2).transpose(1, 2)  # [B, N, C] raster order
        grid = token_grid(cfg)
        pos = (self.pos_embed_spatial.repeat(1, grid[0], 1)
               + torch.repeat_interleave(self.pos_embed_temporal, grid[1] * grid[2], dim=1))
        x = unroll(x + pos.to(dtype), grid, self.schedule(0))
        if keep_idx is None:
            return x
        C = x.shape[-1]
        x = x.view(B, -1, n_units, C)
        idx = keep_idx[:, None, :, None].expand(-1, x.shape[1], -1, C)
        return x.gather(2, idx).reshape(B, -1, C)

    def forward_stages(self, video: torch.Tensor, keep_idx: torch.Tensor | None = None,
                       attn_impl: str = "auto") -> list[torch.Tensor]:
        """Every stage's output (unrolled ``[B, N_s, D_s]``) of normalized
        ``video`` over the kept units (all where ``keep_idx`` is None)."""
        return self.blocks(self.tokens(video, keep_idx), attn_impl)

    def embed(self, video: torch.Tensor, attn_impl: str = "auto") -> torch.Tensor:
        """Pooled embedding ``[B, D_last]`` in f32 of uint8 (or normalized)
        clips: the encoder over every unit, the mean of the last stage's
        tokens, a LayerNorm with unit affine and eps 1e-6, as VideoMAE's."""
        h = self.forward_stages(normalize_on_device(video), None, attn_impl)[-1].float()
        return layer_norm(h.mean(dim=1), None, None, 1e-6)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        return self.embed(video)


def fuse(x: torch.Tensor, head: nn.Conv3d) -> torch.Tensor:
    """A fusion head on ``[B, K, *unit, C]``: its Conv3d, whose kernel is its
    stride, as one product over each output cell's patch; ``[B, K,
    *(unit / kernel), C']``."""
    B, K, C = x.shape[0], x.shape[1], x.shape[-1]
    unit, kernel = x.shape[2:5], head.kernel_size
    out = [u // k for u, k in zip(unit, kernel)]
    x = x.view(B, K, out[0], kernel[0], out[1], kernel[1], out[2], kernel[2], C)
    x = x.permute(0, 1, 2, 4, 6, 8, 3, 5, 7).reshape(B, K, *out, -1)
    w = head.weight.reshape(head.out_channels, -1).to(x.dtype)
    return F.linear(x, w, head.bias.to(x.dtype))


class HieraMAE(nn.Module):
    """Hiera for masked pretraining: :class:`HieraEncoder`, the fusion heads
    and encoder norm, the decoder.  ``forward(video, mask, num_visible,
    attn_impl)`` is the loss, the signature of VideoMAE's ``pretrain_loss``."""

    def __init__(self, cfg: ModelConfig, seed: int = 0):
        """Random weights from one generator seeded with ``seed``: the
        encoder's first, then the fusion heads' and the decoder's."""
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.encoder = HieraEncoder(cfg, generator=gen)
        widths = stage_widths(cfg)
        dim, dec_d = widths[-1], cfg.decoder_hidden_size
        unit = list(cfg.mask_unit_size)
        last = [u // s ** cfg.q_pool for u, s in zip(unit, cfg.q_stride)]
        self.fusion = nn.ModuleList()
        for s in range(cfg.q_pool):
            kernel = tuple(u // m for u, m in zip(unit, last))
            head = nn.Conv3d(widths[s], dim, kernel, kernel)
            trunc_normal_(head.weight, cfg.init_std, gen)
            nn.init.zeros_(head.bias)
            self.fusion.append(head)
            unit = [u // q for u, q in zip(unit, cfg.q_stride)]
        self.norm = LayerNorm(dim, cfg.layer_norm_eps)
        self.decoder_embed = nn.Linear(dim, dec_d)
        init_linear(self.decoder_embed, cfg.init_std, gen)
        self.mask_token = nn.Parameter(torch.empty(1, 1, dec_d))
        trunc_normal_(self.mask_token, cfg.init_std, gen)
        self.decoder_pos_embed = nn.Parameter(torch.empty(1, math.prod(decoder_grid(cfg)), dec_d))
        trunc_normal_(self.decoder_pos_embed, cfg.init_std, gen)
        self.decoder = Blocks(cfg.decoder_depth, dec_d, cfg.decoder_num_heads, cfg.mlp_ratio,
                              cfg.qkv_bias, cfg.layer_norm_eps, cfg.init_std, gen, cfg.remat)
        self.decoder_norm = LayerNorm(dec_d, cfg.layer_norm_eps)
        self.decoder_head = nn.Linear(dec_d, pred_stride(cfg) ** 2 * cfg.in_channels)
        init_linear(self.decoder_head, cfg.init_std, gen)

    def fused(self, stages: list[torch.Tensor], kept: int) -> torch.Tensor:
        """The encoder's output ``[B, K, *unit_last, D]``: the first
        ``q_pool`` stages' outputs through their fusion heads plus the last
        stage's, each rerolled, then the encoder norm."""
        enc = self.encoder
        last = len(stages) - 1
        x = reroll(stages[last], kept, enc.schedule(last))
        for s, head in enumerate(self.fusion):
            x = x + fuse(reroll(stages[s], kept, enc.schedule(s)), head)
        return self.norm(x)

    def decoder_tokens(self, fused: torch.Tensor, keep_idx: torch.Tensor) -> torch.Tensor:
        """The decoder's input ``[B, N_dec, Dd]`` in raster order: the fused
        units at the decoder's width, mask tokens in the dropped units, the
        position table."""
        cfg = self.cfg
        B, K = fused.shape[:2]
        unit = fused.shape[2:5]
        z = F.linear(fused, self.decoder_embed.weight.to(fused.dtype),
                     self.decoder_embed.bias.to(fused.dtype))
        dec_d = z.shape[-1]
        n_units = math.prod(unit_grid(cfg))
        full = self.mask_token.to(z.dtype).expand(B, n_units, math.prod(unit), dec_d)
        idx = keep_idx[:, :, None, None].expand(-1, -1, math.prod(unit), dec_d)
        full = full.scatter(1, idx, z.reshape(B, K, -1, dec_d))
        x = undo_windowing(full.view(B, n_units, *unit, dec_d), unit_grid(cfg), tuple(unit))
        return x.reshape(B, -1, dec_d) + self.decoder_pos_embed.to(z.dtype)

    def masked_tokens(self, mask: torch.Tensor, unit: tuple[int, ...]) -> torch.Tensor:
        """``[B, M]`` raster positions of the decoder tokens in masked units,
        ascending."""
        B = mask.shape[0]
        tok = mask[:, :, None].expand(-1, -1, math.prod(unit)).reshape(B, -1, *unit, 1)
        tok = undo_windowing(tok, unit_grid(self.cfg), unit).reshape(B, -1)
        n_masked = int(mask[0].sum()) * math.prod(unit)
        return mask_partition(tok, tok.shape[1] - n_masked)[1]

    def targets(self, video: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``[B, M, p*p*C]`` f32 labels of the decoder tokens ``idx``: every
        ``tubelet_size``-th frame's ``p x p`` patches (p the decoder's
        stride), (y, x, channel) order, normalized by their mean and
        ``(var_unbiased + 1e-6) ** 0.5``."""
        cfg = self.cfg
        p = pred_stride(cfg)
        x = video[:, ::cfg.tubelet_size].float()
        B, T, H, W, C = x.shape
        x = x.reshape(B, T, H // p, p, W // p, p, C).permute(0, 1, 2, 4, 3, 5, 6)
        x = x.reshape(B, -1, p * p * C)
        x = x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=True, keepdim=True)
        return (x - mean) / (var + 1e-6).sqrt()

    def pretrain_loss(self, video: torch.Tensor, mask: torch.Tensor, num_visible: int,
                      attn_impl: str = "auto") -> torch.Tensor:
        """Masked reconstruction loss, a scalar f32 tensor: the mean squared
        error of the masked units' tokens against their labels.  ``video``
        is uint8 (normalized here) or normalized ``[B, T, H, W, C]``;
        ``mask`` ``[B, units]`` bool, True = masked, ``num_visible`` False a
        row."""
        video = normalize_on_device(video)
        keep_idx, _ = mask_partition(mask, num_visible)
        stages = self.encoder.forward_stages(video, keep_idx, attn_impl)
        with profiler_range("hiera.fusion"):
            fused = self.fused(stages, num_visible)
            x = self.decoder_tokens(fused, keep_idx)
        x = self.decoder(x, attn_impl)
        unit = tuple(fused.shape[2:5])
        idx = self.masked_tokens(mask, unit)
        x = self.decoder_norm(x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1])))
        head = self.decoder_head
        pred = F.linear(x, head.weight.to(x.dtype), head.bias.to(x.dtype))
        return (pred.float() - self.targets(video, idx)).square().mean()

    forward = pretrain_loss  # what DistributedDataParallel calls
