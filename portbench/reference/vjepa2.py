"""V-JEPA 2 in plain f32 PyTorch (Assran et al. 2025, arXiv:2506.09985): the
ViT-g/16 context encoder over the kept context tokens, the predictor, the
EMA target encoder, with 3-D rotary positions in every attention and no
position table; the repository's smooth-L1 objective and SGD-Nesterov
recipe (the configuration's ``assumed`` says where they depart from the
paper's).

- 3-D RoPE: a head of width ``d`` splits into a time, a row and a column
  segment of ``m = 2 floor(floor(d / 3) / 2)`` channels; token id ``n`` of
  the ``(T, H, W)`` grid sits at ``(n // HW, (n mod HW) // W, n mod W)``; in
  each axis's segment the channel pair ``(2k, 2k + 1)`` turns by ``p *
  10000^(-2k/m)`` radians, ``p`` the token's place on that axis (the angle
  in float64, its cosine and sine rounded to f32); the last ``d - 3m``
  channels stay.  Queries and keys, before the softmax's scale.
- Encoder: normalized clips, a tubelet Conv3d, the tokens at the context
  ids, the blocks with RoPE at those ids, a final LayerNorm.
- Target: the EMA encoder over every token (ids ``0 .. N - 1``), a
  LayerNorm without affine (eps 1e-5), the features at the target ids.
- Predictor: the context features embedded to its width, the mask token
  (no table) at each target id, its blocks with RoPE at the context ids
  then the target ids, its norm, the projection back to the encoder width.
- Loss: smooth-L1 (beta 1) over the target rows, divided by their count
  times the width.  Update: as :mod:`portbench.reference.jepa`.

Parameter names are the program's (``encoder.*``, ``predictor.*``; the
target's without a prefix).  The clips are 16 consecutive frames
(:func:`portbench.reference.data.clip_frames`), the masks
:func:`portbench.reference.masks3d.multiblock3d`'s.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import data, jepa, masks3d, vit


def rope(x: torch.Tensor, ids: torch.Tensor, grid: tuple[int, int, int]) -> torch.Tensor:
    """``x [B, N, h, d]`` (f32) turned at the token ids ``ids [B, N]``."""
    T, H, W = grid
    d = x.shape[-1]
    m = 2 * ((d // 3) // 2)
    half = m // 2
    inv = 10000.0 ** (-2.0 * torch.arange(half, dtype=torch.float64, device=x.device) / m)
    places = (ids // (H * W), (ids % (H * W)) // W, ids % W)
    angle = torch.cat([p.double()[..., None] * inv for p in places], dim=-1)  # [B, N, 3m/2]
    c, s = angle.cos().float()[:, :, None, :], angle.sin().float()[:, :, None, :]
    even, odd = x[..., 0:3 * m:2], x[..., 1:3 * m:2]
    turned = torch.stack((even * c - odd * s, odd * c + even * s), dim=-1).flatten(-2)
    return torch.cat((turned, x[..., 3 * m:]), dim=-1)


def block(p: dict, pre: str, x: torch.Tensor, heads: int, eps: float, ids: torch.Tensor,
          grid: tuple[int, int, int], prec: vit.Precision = vit.F32) -> torch.Tensor:
    """One pre-LN block with RoPE; every key attended (the masks keep equal
    counts: no padding)."""
    B, N, D = x.shape
    h = vit.layer_norm(x, p[pre + "ln1.weight"], p[pre + "ln1.bias"], eps)
    qkv = vit.linear(h, p[pre + "qkv.weight"], p[pre + "qkv.bias"], prec)
    qkv = qkv.reshape(B, N, 3, heads, D // heads)
    q, k = rope(qkv[:, :, 0], ids, grid), rope(qkv[:, :, 1], ids, grid)
    a = vit.attention(q, k, qkv[:, :, 2], None, prec)
    x = x + vit.linear(a.reshape(B, N, D), p[pre + "proj.weight"], p[pre + "proj.bias"], prec)
    h = vit.layer_norm(x, p[pre + "ln2.weight"], p[pre + "ln2.bias"], eps)
    h = F.gelu(vit.linear(h, p[pre + "fc1.weight"], p[pre + "fc1.bias"], prec))
    return x + vit.linear(h, p[pre + "fc2.weight"], p[pre + "fc2.bias"], prec)


def encode(p: dict, pre: str, video: torch.Tensor, m: dict, keep: torch.Tensor | None,
           prec: vit.Precision = vit.F32) -> torch.Tensor:
    x = vit.patch_embed(vit.normalize(video), p[pre + "patch_embed.weight"],
                        p[pre + "patch_embed.bias"], m["tubelet_size"], m["patch_size"], prec)
    B, N, D = x.shape
    ids = torch.arange(N, device=x.device).expand(B, N) if keep is None else keep
    if keep is not None:
        x = jepa.gather(x, keep)
    for i in range(m["depth"]):
        x = block(p, f"{pre}blocks.layers.{i}.", x, m["num_heads"], m["layer_norm_eps"], ids,
                  jepa.grid(m), prec)
    return vit.layer_norm(x, p[pre + "norm.weight"], p[pre + "norm.bias"], m["layer_norm_eps"])


def predict(p: dict, z: torch.Tensor, enc: torch.Tensor, pred: torch.Tensor, m: dict,
            prec: vit.Precision = vit.F32) -> torch.Tensor:
    """``[B, Kp, D]`` predictions at ``pred [B, Kp]`` from the context
    features ``z [B, Ke, D]`` at ``enc [B, Ke]``."""
    x = vit.linear(z, p["predictor.embed.weight"], p["predictor.embed.bias"], prec)
    masked = p["predictor.mask_token"].expand(x.shape[0], pred.shape[1], -1)
    x = torch.cat([x, masked], dim=1)
    ids = torch.cat([enc, pred], dim=1)
    heads = m["pred_num_heads"] or m["num_heads"]
    for i in range(m["pred_depth"]):
        x = block(p, f"predictor.blocks.layers.{i}.", x, heads, m["layer_norm_eps"], ids,
                  jepa.grid(m), prec)
    x = vit.layer_norm(x[:, enc.shape[1]:], p["predictor.norm.weight"],
                       p["predictor.norm.bias"], m["layer_norm_eps"])
    return vit.linear(x, p["predictor.proj.weight"], p["predictor.proj.bias"], prec)


def target_features(t: dict, video: torch.Tensor, pred: torch.Tensor, m: dict,
                    prec: vit.Precision = vit.F32) -> torch.Tensor:
    with torch.no_grad():
        h = vit.layer_norm(encode(t, "", video, m, None, prec), None, None, 1e-5)
        return jepa.gather(h, pred)


class Trainer(jepa.Trainer):
    """V-JEPA's trainer with epoch 0's 16-frame clips and the 3-D masks of
    collator steps 0, 1, ... seeded with the run's seed; the EMA as
    :class:`portbench.reference.jepa.Trainer`'s."""

    def step_inputs(self, step: int, global_batch: int) -> dict:
        t, m = self.traffic, self.m
        samples = data.batch_samples(t["n_trainsamples"], global_batch, self.seed, step)
        clips = data.clip_frames(self.corpus["frames"], self.corpus["total"], samples,
                                 m["num_frames"], t["n_trainsamples"])
        enc, pred = masks3d.multiblock3d(self.seed, step, global_batch, jepa.grid(m), self.mask)
        dev = self.device
        return {"video": torch.from_numpy(np.ascontiguousarray(clips)).to(dev),
                "enc": torch.from_numpy(enc).to(dev), "pred": torch.from_numpy(pred).to(dev)}

    def loss_rows(self, p: dict, inputs: dict, lo: int, hi: int,
                  prec: vit.Precision = vit.F32) -> torch.Tensor:
        """Rows ``lo:hi``'s share of the batch's smooth-L1."""
        video, enc, pred = inputs["video"][lo:hi], inputs["enc"][lo:hi], inputs["pred"][lo:hi]
        want = target_features(self.target, video, pred, self.m, prec)
        got = predict(p, encode(p, "encoder.", video, self.m, enc, prec), enc, pred, self.m,
                      prec)
        denom = inputs["pred"].numel() * got.shape[-1]
        return jepa.smooth_l1(got, want).sum() / denom
