"""V-JEPA in plain f32 PyTorch (Bardes et al. 2024; the reference's
``pretraining/predictive/``): a video ViT context encoder over the kept
context tokens, a narrow predictor, an EMA target encoder, smooth-L1.

- Encoder: normalized clips, a tubelet Conv3d, the 3-D position table, the
  tokens at the context indices (-1 padding read as token 0 and left out of
  every attention as a key), the blocks, a final LayerNorm.
- Target: the EMA encoder over every token, a LayerNorm without affine
  (eps 1e-5), the features at each prediction mask's indices.
- Predictor: the context features embedded to its width plus its own
  table at the context positions, repeated mask-major for the M masks;
  mask tokens plus the table at each mask's positions appended; its blocks
  with the context's and the mask's key validity; its norm; a projection
  back to the encoder's width; the mask tokens' outputs.
- Loss: smooth-L1 (beta 1) over the valid prediction rows, summed and
  divided by their count times the width.
- Update: after the optimizer's step ``i`` (from 0), ``target = m * target
  + (1 - m) * encoder`` with ``m = ema0 + i * (ema1 - ema0) / total_steps``
  while ``i < total_steps + 5``.

Parameter names are the program's (``encoder.*``, ``predictor.*``; the
target's without a prefix).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import data, masks, vit


def grid(m: dict) -> tuple[int, int, int]:
    g = m["image_size"] // m["patch_size"]
    return m["num_frames"] // m["tubelet_size"], g, g


def tokens(p: dict, pre: str, video: torch.Tensor, m: dict,
           prec: vit.Precision = vit.F32) -> torch.Tensor:
    x = vit.patch_embed(vit.normalize(video), p[pre + "patch_embed.weight"],
                        p[pre + "patch_embed.bias"], m["tubelet_size"], m["patch_size"], prec)
    return x + vit.position_table_3d(*grid(m), x.shape[2]).to(x.device)


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.gather(1, idx.clamp(min=0)[..., None].expand(-1, -1, x.shape[-1]))


def encode(p: dict, pre: str, video: torch.Tensor, m: dict, keep: torch.Tensor | None,
           prec: vit.Precision = vit.F32) -> torch.Tensor:
    x = tokens(p, pre, video, m, prec)
    valid = None
    if keep is not None:
        x, valid = gather(x, keep), keep >= 0
    x = vit.blocks(p, pre + "blocks.", x, m["depth"], m["num_heads"], m["layer_norm_eps"],
                   valid, prec)
    return vit.layer_norm(x, p[pre + "norm.weight"], p[pre + "norm.bias"], m["layer_norm_eps"])


def predict(p: dict, z: torch.Tensor, enc: torch.Tensor, pred: torch.Tensor, m: dict,
            prec: vit.Precision = vit.F32) -> torch.Tensor:
    """``[M, B, Kp, D]`` predictions at ``pred [M, B, Kp]`` from the context
    features ``z [B, Ke, D]`` at ``enc [B, Ke]``."""
    M, B, Kp = pred.shape
    Ke = enc.shape[1]
    table = vit.position_table_3d(*grid(m), m["pred_emb_dim"]).to(z.device)
    x = vit.linear(z, p["predictor.embed.weight"], p["predictor.embed.bias"], prec)
    x = x + table[enc.clamp(min=0)]
    x = x[None].expand(M, -1, -1, -1).reshape(M * B, Ke, -1)
    masked = (p["predictor.mask_token"] + table[pred.clamp(min=0)]).reshape(M * B, Kp, -1)
    valid = torch.cat([(enc >= 0)[None].expand(M, -1, -1).reshape(M * B, Ke),
                       (pred >= 0).reshape(M * B, Kp)], dim=1)
    x = vit.blocks(p, "predictor.blocks.", torch.cat([x, masked], dim=1), m["pred_depth"],
                   m["num_heads"], m["layer_norm_eps"], valid, prec)
    x = vit.layer_norm(x[:, Ke:], p["predictor.norm.weight"], p["predictor.norm.bias"],
                       m["layer_norm_eps"])
    x = vit.linear(x, p["predictor.proj.weight"], p["predictor.proj.bias"], prec)
    return x.reshape(M, B, Kp, -1)


def target_features(t: dict, video: torch.Tensor, pred: torch.Tensor, m: dict,
                    prec: vit.Precision = vit.F32) -> torch.Tensor:
    with torch.no_grad():
        h = vit.layer_norm(encode(t, "", video, m, None, prec), None, None, 1e-5)
        return torch.stack([gather(h, pred[i]) for i in range(pred.shape[0])])


def smooth_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.smooth_l1_loss(a, b, reduction="none", beta=1.0)


class Trainer:
    """The inputs, loss and EMA update of the reference's V-JEPA steps: the
    pairs of epoch 0's global batches and the multi-block masks of
    collator steps 0, 1, ... seeded with the run's seed."""

    def __init__(self, cfg: dict, traffic: dict, corpus: dict, seed: int, device,
                 global_batch: int):
        self.m, self.mask, self.optim = cfg["model"], cfg["mask"], cfg["optim"]
        self.traffic, self.corpus, self.seed, self.device = traffic, corpus, seed, device
        # the EMA ramp's horizon: the run's steps, n_epoch epochs of whole global batches
        self.total_steps = traffic["n_trainsamples"] // global_batch * traffic["n_epoch"]
        self.target: dict | None = None

    def start(self, params: dict) -> None:
        """The EMA encoder starts as the online one."""
        self.target = {k[len("encoder."):]: v.detach().clone()
                       for k, v in params.items() if k.startswith("encoder.")}

    def step_inputs(self, step: int, global_batch: int) -> dict:
        t = self.traffic
        samples = data.batch_samples(t["n_trainsamples"], global_batch, self.seed, step)
        pairs = data.pair_frames(self.corpus["frames"], self.corpus["total"], samples,
                                 t["data"]["interval"], t["n_trainsamples"])
        enc, pred = masks.multiblock(self.seed, step, global_batch, grid(self.m), self.mask)
        dev = self.device
        return {"video": torch.from_numpy(np.ascontiguousarray(pairs)).to(dev),
                "enc": torch.from_numpy(enc).to(dev),
                "pred": torch.from_numpy(pred).to(dev).transpose(0, 1)}

    def loss_rows(self, p: dict, inputs: dict, lo: int, hi: int,
                  prec: vit.Precision = vit.F32) -> torch.Tensor:
        """Rows ``lo:hi``'s share of the batch's smooth-L1."""
        video, enc, pred = inputs["video"][lo:hi], inputs["enc"][lo:hi], inputs["pred"][:, lo:hi]
        want = target_features(self.target, video, pred, self.m, prec)
        got = predict(p, encode(p, "encoder.", video, self.m, enc, prec), enc, pred, self.m, prec)
        valid = (pred >= 0).float()[..., None]
        denom = (inputs["pred"] >= 0).float().sum() * got.shape[-1]
        return (smooth_l1(got, want) * valid).sum() / denom

    def after_update(self, params: dict, step: int) -> None:
        e0, e1 = self.optim["ema"]
        total = self.total_steps
        mom = e0 + step * (e1 - e0) / max(total, 1) if step < total + 5 else \
            self.optim["ema_fallback"]
        with torch.no_grad():
            for k, v in self.target.items():
                v.mul_(mom).add_(params["encoder." + k].detach(), alpha=1.0 - mom)
