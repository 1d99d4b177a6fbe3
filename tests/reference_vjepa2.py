"""A plain V-JEPA 2 reference in f32 PyTorch, for the CPU tests of the port.

Written from the V-JEPA 2 paper (Assran et al. 2025, arXiv:2506.09985) and
the port's JEPA objective, with no kernel, operator or module of the port
and nothing of JAX: parameters are a flat dict of tensors under the port's
names (``encoder.*``, ``predictor.*``; the EMA target's without a prefix).

- 3-D RoPE (:func:`rope`): each head of width ``d`` splits into a time, a
  row and a column segment of ``m = 2 floor(floor(d/3)/2)`` channels; token
  id ``n`` of the ``(T, H, W)`` grid sits at ``(n // HW, (n mod HW) // W, n
  mod W)``; in the segment of an axis, channel pair ``(2k, 2k+1)`` turns by
  ``p * 10000^(-2k/m)`` radians (``p`` the token's place on that axis); the
  last ``d - 3m`` channels stay.  Queries and keys only, before the scale.
- Blocks: pre-LN, fused qkv, softmax attention over the valid keys, erf
  GELU MLP.
- Encoder: ``(x/255 - 0.5)/0.25``, a tubelet Conv3d, no position table, the
  tokens at the context ids (``-1`` pads read as token 0 at position 0 and
  never attended), the blocks with RoPE at those ids, a final LayerNorm.
- Target: the EMA encoder over every token (ids ``0 .. N-1``), a LayerNorm
  without affine (eps 1e-5), the features at the prediction ids.
- Predictor: the context features embedded to its width, the bare mask
  token at each prediction id, its blocks over both with RoPE at the context
  ids then the prediction ids, its norm, the projection back.
- Loss: smooth-L1 (beta 1) over the valid prediction rows, divided by their
  count times the width.  Update: SGD with Nesterov momentum (PyTorch's
  form), then ``target = m target + (1 - m) encoder``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rope(x: torch.Tensor, ids: torch.Tensor, grid: tuple[int, int, int]) -> torch.Tensor:
    """``x [B, N, h, d]`` turned at the token ids ``ids [B, N]`` (pads -1
    read as 0), pair by pair, each angle in float64 then f32."""
    T, H, W = grid
    d = x.shape[-1]
    m = 2 * ((d // 3) // 2)
    ids = ids.clamp(min=0).long()
    places = (ids // (H * W), (ids % (H * W)) // W, ids % W)
    cols = list(x.unbind(-1))
    for axis, place in enumerate(places):
        for k in range(m // 2):
            theta = place.double() * 10000.0 ** (-2.0 * k / m)
            c, s = theta.cos().float()[..., None], theta.sin().float()[..., None]
            a = axis * m + 2 * k
            x0, x1 = x[..., a], x[..., a + 1]
            cols[a], cols[a + 1] = x0 * c - x1 * s, x1 * c + x0 * s
    return torch.stack(cols, dim=-1)


def attention(q, k, v, valid):
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if valid is not None:
        scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), v)


def block(p: dict, pre: str, x: torch.Tensor, heads: int, eps: float, ids, grid, valid):
    B, N, D = x.shape
    h = F.layer_norm(x, (D,), p[pre + "ln1.weight"], p[pre + "ln1.bias"], eps)
    qkv = F.linear(h, p[pre + "qkv.weight"], p[pre + "qkv.bias"]).reshape(B, N, 3, heads, -1)
    q, k = rope(qkv[:, :, 0], ids, grid), rope(qkv[:, :, 1], ids, grid)
    a = attention(q, k, qkv[:, :, 2], valid).reshape(B, N, D)
    x = x + F.linear(a, p[pre + "proj.weight"], p[pre + "proj.bias"])
    h = F.layer_norm(x, (D,), p[pre + "ln2.weight"], p[pre + "ln2.bias"], eps)
    h = F.gelu(F.linear(h, p[pre + "fc1.weight"], p[pre + "fc1.bias"]))
    return x + F.linear(h, p[pre + "fc2.weight"], p[pre + "fc2.bias"])


def grid_of(cfg) -> tuple[int, int, int]:
    g = cfg.image_size // cfg.patch_size
    return cfg.num_frames // cfg.tubelet_size, g, g


def encode(p: dict, pre: str, video: torch.Tensor, cfg, keep: torch.Tensor | None):
    """Final-normed encoder features ``[B, K, D]`` at the ids ``keep [B,
    K]`` (every token without)."""
    D, ts, ps = cfg.hidden_size, cfg.tubelet_size, cfg.patch_size
    x = ((video.float() / 255.0 - 0.5) / 0.25).permute(0, 4, 1, 2, 3)
    w = p[pre + "patch_embed.weight"].reshape(D, x.shape[1], ts, ps, ps)
    x = F.conv3d(x, w, p[pre + "patch_embed.bias"], stride=(ts, ps, ps)).flatten(2).mT
    B, N = x.shape[:2]
    ids, valid = torch.arange(N).expand(B, N), None
    if keep is not None:
        ids, valid = keep, keep >= 0
        x = x.gather(1, keep.clamp(min=0)[..., None].expand(-1, -1, D))
    for i in range(cfg.depth):
        x = block(p, f"{pre}blocks.layers.{i}.", x, cfg.num_heads, cfg.layer_norm_eps, ids,
                  grid_of(cfg), valid)
    return F.layer_norm(x, (D,), p[pre + "norm.weight"], p[pre + "norm.bias"],
                        cfg.layer_norm_eps)


def predict(p: dict, z: torch.Tensor, enc: torch.Tensor, pred: torch.Tensor, cfg):
    """``[B, Kp, D]`` predictions at ``pred [B, Kp]`` from the context
    features ``z`` at ``enc [B, Ke]`` (one prediction mask)."""
    Dp = cfg.pred_emb_dim
    x = F.linear(z, p["predictor.embed.weight"], p["predictor.embed.bias"])
    masked = p["predictor.mask_token"].expand(x.shape[0], pred.shape[1], Dp)
    x = torch.cat([x, masked], dim=1)
    ids, valid = torch.cat([enc, pred], dim=1), torch.cat([enc, pred], dim=1) >= 0
    for i in range(cfg.pred_depth):
        x = block(p, f"predictor.blocks.layers.{i}.", x, cfg.pred_num_heads or cfg.num_heads,
                  cfg.layer_norm_eps, ids, grid_of(cfg), valid)
    x = F.layer_norm(x[:, enc.shape[1]:], (Dp,), p["predictor.norm.weight"],
                     p["predictor.norm.bias"], cfg.layer_norm_eps)
    return F.linear(x, p["predictor.proj.weight"], p["predictor.proj.bias"])


def target_features(t: dict, video: torch.Tensor, pred: torch.Tensor, cfg) -> torch.Tensor:
    with torch.no_grad():
        h = encode(t, "", video, cfg, None)
        h = F.layer_norm(h, (h.shape[-1],), eps=1e-5)
        return h.gather(1, pred.clamp(min=0)[..., None].expand(-1, -1, h.shape[-1]))


def loss(p: dict, target: dict, video, enc, pred, cfg) -> torch.Tensor:
    want = target_features(target, video, pred, cfg)
    got = predict(p, encode(p, "encoder.", video, cfg, enc), enc, pred, cfg)
    valid = (pred >= 0).float()[..., None]
    per = F.smooth_l1_loss(got, want, reduction="none", beta=1.0) * valid
    return per.sum() / (valid.sum() * got.shape[-1])


def train(params: dict, batches: list[dict], cfg, lr: float, momentum: float,
          ema: tuple[float, float], total_steps: int) -> list[dict]:
    """SGD-Nesterov steps over ``batches`` (``video``, ``enc_idx [B, Ke]``,
    ``pred_idx [B, 1, Kp]``) from ``params``, the target starting as the
    encoder; after each step ``{"loss", "grads", "params", "target"}``."""
    p = {k: v.detach().clone().float().requires_grad_(True) for k, v in params.items()}
    target = {k[len("encoder."):]: v.detach().clone() for k, v in p.items()
              if k.startswith("encoder.")}
    buf: dict[str, torch.Tensor] = {}
    out = []
    for i, b in enumerate(batches):
        value = loss(p, target, b["video"], b["enc_idx"], b["pred_idx"][:, 0], cfg)
        grads = dict(zip(p, torch.autograd.grad(value, list(p.values()))))
        with torch.no_grad():
            for k, v in p.items():
                g = grads[k]
                buf[k] = g.clone() if i == 0 else buf[k].mul_(momentum).add_(g)
                v.sub_(lr * (g + momentum * buf[k]))
            m = ema[0] + i * (ema[1] - ema[0]) / total_steps
            for k, v in target.items():
                v.mul_(m).add_(p["encoder." + k].detach(), alpha=1.0 - m)
        out.append({"loss": float(value.detach()), "grads": grads,
                    "params": {k: v.detach().clone() for k, v in p.items()},
                    "target": {k: v.clone() for k, v in target.items()}})
    return out
