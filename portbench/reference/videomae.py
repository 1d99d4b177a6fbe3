"""VideoMAE in plain f32 PyTorch: tube-masked pretraining (Tong et al.
2022; HF ``VideoMAEForPreTraining`` with norm-pix loss and mean pooling)
and the pooled embedding of ``VideoMAEForVideoClassification(num_labels=0)``.

Pretraining: normalized clips, the patch embedding of every token plus the
1-D sinusoid table, the visible tokens (ascending positions) through the
encoder blocks (no final norm), ``enc_to_dec`` without bias, the mask token
with the decoder's table at the masked positions appended, the decoder
blocks over all tokens, the decoder norm and head on the masked tokens, and
the mean squared error against each masked patch's pixels normalized per
channel over its ``ts*p*p`` pixels (unbiased std, plus 1e-6), features in
(pixel, channel) order.  Embedding: the encoder over all tokens, the mean
over tokens, a LayerNorm without affine (eps 1e-6).

Parameter names are the program's (``encoder.patch_embed.*``,
``encoder.blocks.layers.{i}.*``, ``enc_to_dec.weight``, ``mask_token``,
``decoder.layers.{i}.*``, ``decoder_norm.*``, ``decoder_head.*``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import data, masks, vit


def grid(m: dict) -> tuple[int, int, int]:
    g = m["image_size"] // m["patch_size"]
    return m["num_frames"] // m["tubelet_size"], g, g


def encoder_tokens(p: dict, pre: str, video: torch.Tensor, m: dict,
                   prec: vit.Precision = vit.F32) -> torch.Tensor:
    """Normalized clips to embedded tokens with positions, ``[B, N, D]``."""
    x = vit.patch_embed(vit.normalize(video), p[pre + "patch_embed.weight"],
                        p[pre + "patch_embed.bias"], m["tubelet_size"], m["patch_size"], prec)
    return x + vit.sinusoid_table(x.shape[1], x.shape[2]).to(x.device)


def embed(p: dict, video: torch.Tensor, m: dict, prec: vit.Precision = vit.F32) -> torch.Tensor:
    """``[B, D]`` pooled embeddings of uint8 ``[B, T, H, W, C]`` clips
    (parameters without the ``encoder.`` prefix)."""
    x = encoder_tokens(p, "", video, m, prec)
    x = vit.blocks(p, "blocks.", x, m["depth"], m["num_heads"], m["layer_norm_eps"], None, prec)
    return vit.layer_norm(x.mean(dim=1), None, None, 1e-6)


def norm_pix_targets(video: torch.Tensor, m: dict, idx: torch.Tensor) -> torch.Tensor:
    """``[B, K, ts*p*p*C]`` targets of the tokens ``idx [B, K]``."""
    B, T, H, W, C = video.shape
    ts, ps = m["tubelet_size"], m["patch_size"]
    x = vit.normalize(video).reshape(B, T // ts, ts, H // ps, ps, W // ps, ps, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, -1, ts * ps * ps, C)
    x = x.gather(1, idx[:, :, None, None].expand(-1, -1, x.shape[2], C))
    x = (x - x.mean(dim=2, keepdim=True)) / (x.std(dim=2, unbiased=True, keepdim=True) + 1e-6)
    return x.reshape(B, idx.shape[1], -1)


def pretrain_loss_sum(p: dict, video: torch.Tensor, masked: torch.Tensor, m: dict,
                      prec: vit.Precision = vit.F32) -> torch.Tensor:
    """Sum of the squared errors over the masked tokens' features."""
    vis, msk = masks.visible_and_masked(masked)
    eps = m["layer_norm_eps"]
    tokens = encoder_tokens(p, "encoder.", video, m, prec)
    x = tokens.gather(1, vis[..., None].expand(-1, -1, tokens.shape[2]))
    x = vit.blocks(p, "encoder.blocks.", x, m["depth"], m["num_heads"], eps, None, prec)
    z = vit.linear(x, p["enc_to_dec.weight"], None, prec)
    pos = vit.sinusoid_table(masked.shape[1], z.shape[2]).to(z.device)
    x = torch.cat([z + pos[vis], p["mask_token"] + pos[msk]], dim=1)
    x = vit.blocks(p, "decoder.", x, m["decoder_depth"], m["decoder_num_heads"], eps, None, prec)
    x = vit.layer_norm(x[:, -msk.shape[1]:], p["decoder_norm.weight"], p["decoder_norm.bias"],
                       eps)
    pred = vit.linear(x, p["decoder_head.weight"], p["decoder_head.bias"], prec)
    return (pred - norm_pix_targets(video, m, msk)).square().sum()


class Trainer:
    """The inputs and loss of the reference's VideoMAE steps: the clips of
    epoch 0's global batches and the tube masks of ``seed + 1``'s
    generator, drawn for the global batch step by step."""

    target = None  # no EMA encoder

    def __init__(self, cfg: dict, traffic: dict, corpus: dict, seed: int, device,
                 global_batch: int):
        self.m, self.mask = cfg["model"], cfg["mask"]
        self.traffic, self.corpus, self.seed, self.device = traffic, corpus, seed, device
        self.gen = torch.Generator(device=device).manual_seed(seed + 1)

    def step_inputs(self, step: int, global_batch: int) -> dict:
        t = self.traffic
        samples = data.batch_samples(t["n_trainsamples"], global_batch, self.seed, step)
        clips = data.clip_frames(self.corpus["frames"], self.corpus["total"], samples,
                                 self.m["num_frames"], t["n_trainsamples"])
        masked = masks.tube_masked(self.gen, global_batch, grid(self.m), self.mask["mask_ratio"])
        return {"video": torch.from_numpy(np.ascontiguousarray(clips)).to(self.device),
                "masked": masked}

    def loss_rows(self, p: dict, inputs: dict, lo: int, hi: int,
                  prec: vit.Precision = vit.F32) -> torch.Tensor:
        """Rows ``lo:hi``'s share of the batch's mean squared error."""
        video, masked = inputs["video"], inputs["masked"]
        B, n_masked = masked.shape[0], int(masked[0].sum())
        feats = self.m["in_channels"] * self.m["tubelet_size"] * self.m["patch_size"] ** 2
        return pretrain_loss_sum(p, video[lo:hi], masked[lo:hi], self.m, prec) / (
            B * n_masked * feats)

    def start(self, params: dict) -> None:
        pass

    def after_update(self, params: dict, step: int) -> None:
        pass
