"""A plain Hiera video MAE reference in f32 PyTorch, for the CPU tests of the
port (TF32 off on a card; nothing of the port's kernels, operators or
modules, nothing of JAX).

Written from the paper's equations (Ryali et al. 2023, arXiv:2306.00989,
``hiera_mae.py``), with explicit index arithmetic in place of the unrolled
order: each token's ``(t, y, x)`` on its stage's grid gives its mask unit
``((t // ut) Uy + y // uy) Ux + x // ux`` and its place ``((t % ut) uy +
y % uy) ux + x % ux`` in the unit (:func:`unit_places`), and a stage's
tokens are held as ``[B, K, *unit, C]``: the kept units in ascending
order, each unit's tokens in raster order.  Attention does not depend on
the order of the tokens, and a 2 x 2 pool is ``F.max_pool3d`` within a
unit.  The masked conv multiplies each pixel by 1 if its unit is kept;
fusion heads are ``F.conv3d``; the decoder places each token at its raster
position by the same arithmetic.  Parameters are a flat dict under the
port's names (``encoder.*``, ``fusion.{i}.*``, ``norm``, ``decoder_*``,
``mask_token``, ``decoder.layers.{i}.*``); ``m`` is a dict of the port's
``ModelConfig`` fields.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def linear(x, w, b):
    return F.linear(x, w, b)


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def normalize(video: torch.Tensor) -> torch.Tensor:
    return (video.float() / 255.0 - 0.5) / 0.25


def attention(q, k, v):
    """Softmax attention over ``[B, Nq, h, d]`` queries and ``[B, Nk, h, d]``
    keys and values, scale d^-1/2."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    return torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), v)


def vit_blocks(p: dict, pre: str, x: torch.Tensor, depth: int, heads: int, eps: float):
    """Pre-LN ViT blocks: ``x + proj(attn(qkv(ln1(x))))``, ``x +
    fc2(gelu(fc1(ln2(x))))``."""
    for i in range(depth):
        q_ = f"{pre}layers.{i}."
        B, N, D = x.shape
        h = layer_norm(x, p[q_ + "ln1.weight"], p[q_ + "ln1.bias"], eps)
        qkv = linear(h, p[q_ + "qkv.weight"], p[q_ + "qkv.bias"]).reshape(B, N, 3, heads, -1)
        a = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).reshape(B, N, D)
        x = x + linear(a, p[q_ + "proj.weight"], p[q_ + "proj.bias"])
        h = layer_norm(x, p[q_ + "ln2.weight"], p[q_ + "ln2.bias"], eps)
        x = x + linear(F.gelu(linear(h, p[q_ + "fc1.weight"], p[q_ + "fc1.bias"])),
                       p[q_ + "fc2.weight"], p[q_ + "fc2.bias"])
    return x


def token_grid(m: dict) -> tuple[int, int, int]:
    return (m["num_frames"] // m["tubelet_size"], m["image_size"] // m["patch_size"],
            m["image_size"] // m["patch_size"])


def unit_grid(m: dict) -> tuple[int, int, int]:
    return tuple(g // u for g, u in zip(token_grid(m), m["mask_unit_size"]))


def unit_places(grid: tuple[int, int, int], unit: tuple[int, int, int], device) -> torch.Tensor:
    """``[units, per_unit]`` raster index (on ``grid``) of place ``p`` of
    unit ``u``: token ``(t, y, x)`` is in unit ``((t // ut) Uy + y // uy) Ux
    + x // ux`` at place ``((t % ut) uy + y % uy) ux + x % ux``."""
    T, H, W = grid
    ut, uy, ux = unit
    Uy, Ux = H // uy, W // ux
    t, y, x = torch.meshgrid(torch.arange(T, device=device), torch.arange(H, device=device),
                             torch.arange(W, device=device), indexing="ij")
    u = ((t // ut) * Uy + y // uy) * Ux + x // ux
    place = ((t % ut) * uy + y % uy) * ux + x % ux
    out = torch.empty((T * H * W // (ut * uy * ux), ut * uy * ux), dtype=torch.long,
                      device=device)
    out[u.flatten(), place.flatten()] = ((t * H + y) * W + x).flatten()
    return out


def mask_unit_masked(generator: torch.Generator, rows: int, units: int,
                     ratio: float) -> torch.Tensor:
    """``[rows, units]`` bool, True = masked."""
    k = units - int(units * (1 - ratio))
    order = torch.rand((rows, units), generator=generator, device=generator.device).argsort(1)
    out = torch.zeros((rows, units), dtype=torch.bool, device=generator.device)
    return out.scatter_(1, order[:, :k], True)


def pool_units(x: torch.Tensor, stride: tuple[int, int, int]) -> torch.Tensor:
    """Max over ``stride`` cells within each unit of ``[B, K, ut, uy, ux,
    C]``."""
    B, K, ut, uy, ux, C = x.shape
    y = F.max_pool3d(x.reshape(B * K, ut, uy, ux, C).permute(0, 4, 1, 2, 3), stride, stride)
    return y.permute(0, 2, 3, 4, 1).reshape(B, K, *y.shape[2:], C)


def hiera_block(p: dict, pre: str, x: torch.Tensor, dim_out: int, heads: int, pool: bool,
                mask_unit: bool, m: dict) -> torch.Tensor:
    B, K = x.shape[:2]
    eps, stride = m["layer_norm_eps"], tuple(m["q_stride"])
    h = layer_norm(x, p[pre + "ln1.weight"], p[pre + "ln1.bias"], eps)
    if pre + "dim_proj.weight" in p:
        x = linear(h, p[pre + "dim_proj.weight"], p[pre + "dim_proj.bias"])
        if pool:
            x = pool_units(x, stride)
    qkv = linear(h, p[pre + "qkv.weight"], p[pre + "qkv.bias"])
    q, k, v = qkv.chunk(3, dim=-1)
    if pool:
        q = pool_units(q, stride)
    unit_q, unit_kv = q.shape[2:5], k.shape[2:5]
    nq, nk = math.prod(unit_q), math.prod(unit_kv)
    if mask_unit:  # within each unit
        shape_q, shape_kv = (B * K, nq, heads, -1), (B * K, nk, heads, -1)
    else:  # over every kept token
        shape_q, shape_kv = (B, K * nq, heads, -1), (B, K * nk, heads, -1)
    a = attention(q.reshape(shape_q), k.reshape(shape_kv), v.reshape(shape_kv))
    a = a.reshape(B, K, *unit_q, dim_out)
    x = x + linear(a, p[pre + "proj.weight"], p[pre + "proj.bias"])
    h = layer_norm(x, p[pre + "ln2.weight"], p[pre + "ln2.bias"], eps)
    h = F.gelu(linear(h, p[pre + "fc1.weight"], p[pre + "fc1.bias"]))
    return x + linear(h, p[pre + "fc2.weight"], p[pre + "fc2.bias"])


def kept_tokens(p: dict, video: torch.Tensor, kept: torch.Tensor, m: dict) -> torch.Tensor:
    """Normalized clips to the kept units' tokens ``[B, K, *unit, C]``
    (``kept [B, K]`` ascending unit indices)."""
    B, Tf, Hp, Wp, _ = video.shape
    grid, unit, units = token_grid(m), tuple(m["mask_unit_size"]), unit_grid(m)
    n_units = math.prod(units)
    keep = torch.zeros((B, n_units), device=video.device)
    keep.scatter_(1, kept, 1.0)
    # the unit of each pixel (f, i, j)
    f = torch.arange(Tf, device=video.device) // (Tf // units[0])
    i = torch.arange(Hp, device=video.device) // (Hp // units[1])
    j = torch.arange(Wp, device=video.device) // (Wp // units[2])
    pix_unit = (f[:, None, None] * units[1] + i[None, :, None]) * units[2] + j[None, None, :]
    x = video * keep[:, pix_unit][..., None]
    w = p["encoder.patch_embed.weight"]
    stride = (m["tubelet_size"], m["patch_size"], m["patch_size"])
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, p["encoder.patch_embed.bias"], stride,
                 tuple(m["patch_padding"]))
    y = y.flatten(2).transpose(1, 2)  # [B, N, C] raster
    T, H, W = grid
    r = torch.arange(T * H * W, device=video.device)
    y = y + (p["encoder.pos_embed_spatial"][0, r % (H * W)]
             + p["encoder.pos_embed_temporal"][0, r // (H * W)])
    places = unit_places(grid, unit, video.device)[kept]  # [B, K, per_unit]
    C = y.shape[-1]
    y = y.gather(1, places.reshape(B, -1)[..., None].expand(-1, -1, C))
    return y.reshape(B, kept.shape[1], *unit, C)


def encoder_stages(p: dict, video: torch.Tensor, kept: torch.Tensor,
                   m: dict) -> list[torch.Tensor]:
    """Every stage's output ``[B, K, *unit_s, C_s]``."""
    x = kept_tokens(p, video, kept, m)
    outs, i = [], 0
    for s, depth in enumerate(m["stage_depths"]):
        dim = int(m["hidden_size"] * m["dim_mul"] ** s)
        lag = s > 0 and m["mask_unit_attn"][s - 1]
        for b in range(depth):
            pool = b == 0 and 0 < s <= m["q_pool"]
            x = hiera_block(p, f"encoder.blocks.layers.{i}.", x, dim, m["stage_heads"][s], pool,
                            m["mask_unit_attn"][s] or (lag and b == 0), m)
            i += 1
        outs.append(x)
    return outs


def decoder_grid(m: dict) -> tuple[int, int, int]:
    pooled = [s ** m["q_pool"] for s in m["q_stride"]]
    return tuple(g // q for g, q in zip(token_grid(m), pooled))


def pretrain_loss_sum(p: dict, video: torch.Tensor, masked: torch.Tensor,
                      m: dict) -> torch.Tensor:
    """Sum of the squared errors over the masked units' tokens' features;
    ``masked [B, units]`` bool, as many a row."""
    B, n_units = masked.shape
    pos = torch.arange(n_units, device=masked.device).expand(B, -1)
    kept = pos[~masked].reshape(B, -1)
    x = normalize(video)
    stages = encoder_stages(p, x, kept, m)
    fused = stages[-1]
    for s in range(m["q_pool"]):
        z = stages[s]
        K, C = z.shape[1], z.shape[-1]
        w = p[f"fusion.{s}.weight"]
        y = F.conv3d(z.reshape(B * K, *z.shape[2:5], C).permute(0, 4, 1, 2, 3), w,
                     p[f"fusion.{s}.bias"], stride=tuple(w.shape[2:]))
        fused = fused + y.permute(0, 2, 3, 4, 1).reshape(fused.shape)
    fused = layer_norm(fused, p["norm.weight"], p["norm.bias"], m["layer_norm_eps"])
    z = linear(fused, p["decoder_embed.weight"], p["decoder_embed.bias"])
    unit = tuple(z.shape[2:5])
    Dd = z.shape[-1]
    full = p["mask_token"].reshape(1, 1, 1, Dd).expand(B, n_units, math.prod(unit), Dd).clone()
    full[torch.arange(B, device=z.device)[:, None], kept] = z.reshape(B, kept.shape[1], -1, Dd)
    grid = decoder_grid(m)
    places = unit_places(grid, unit, z.device).flatten()  # raster index of (unit, place)
    x = torch.empty((B, math.prod(grid), Dd), device=z.device, dtype=z.dtype)
    x = x.index_copy(1, places, full.reshape(B, -1, Dd)) + p["decoder_pos_embed"]
    x = vit_blocks(p, "decoder.", x, m["decoder_depth"], m["decoder_num_heads"],
                   m["layer_norm_eps"])
    # the masked units' tokens, ascending raster positions
    tok_masked = torch.empty((B, math.prod(grid)), dtype=torch.bool, device=z.device)
    tok_masked[:, places] = masked[:, :, None].expand(-1, -1, math.prod(unit)).reshape(B, -1)
    idx = torch.arange(math.prod(grid), device=z.device).expand(B, -1)[tok_masked].reshape(B, -1)
    x = x.gather(1, idx[..., None].expand(-1, -1, Dd))
    x = layer_norm(x, p["decoder_norm.weight"], p["decoder_norm.bias"], m["layer_norm_eps"])
    pred = linear(x, p["decoder_head.weight"], p["decoder_head.bias"])
    return (pred - labels(video, idx, m)).square().sum()


def labels(video: torch.Tensor, idx: torch.Tensor, m: dict) -> torch.Tensor:
    """``[B, M, p*p*C]`` labels of the decoder tokens ``idx``."""
    ps = m["patch_size"] * m["q_stride"][-1] ** m["q_pool"]
    x = normalize(video)[:, ::m["tubelet_size"]]
    B, T, H, W, C = x.shape
    x = x.reshape(B, T, H // ps, ps, W // ps, ps, C).permute(0, 1, 2, 4, 3, 5, 6)
    x = x.reshape(B, -1, ps * ps * C)
    x = x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return (x - x.mean(-1, keepdim=True)) / (x.var(-1, unbiased=True, keepdim=True) + 1e-6).sqrt()
