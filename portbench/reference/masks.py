"""The masks of a training step, worked out again from the seed.

- Tube masks (VideoMAE): a row of uniform draws per clip from a
  ``torch.Generator`` seeded with ``seed + 1`` on the device of the step,
  argsorted; the first ``int(ratio * h * w)`` spatial patches of the
  permutation are masked in every temporal sheet.  One draw of the global
  batch per step, in step order.
- Multi-block masks (V-JEPA), the reference ``MaskCollator``
  (``pretraining/predictive/mask.py``) with fixed caps: per batch one block
  size for the prediction masks and one for the context mask, from a numpy
  generator seeded ``(seed, step)``; per clip ``npred`` prediction blocks,
  then a context block outside them, by rejection sampling that drops a
  constraint after every 20 tries; every clip cut to the batch's smallest
  counts, padded with -1 to the caps; context tokens on the first temporal
  sheet, prediction tokens on the last.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def tube_masked(generator: torch.Generator, rows: int, grid: tuple[int, int, int],
                ratio: float) -> torch.Tensor:
    """``[rows, t*h*w]`` bool, True = masked."""
    t, h, w = grid
    k = int(ratio * h * w)
    order = torch.rand((rows, h * w), generator=generator, device=generator.device).argsort(1)
    frame = torch.zeros((rows, h * w), dtype=torch.bool, device=generator.device)
    frame.scatter_(1, order[:, :k], True)
    return frame.repeat(1, t)


def visible_and_masked(masked: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Ascending token positions of the visible and of the masked tokens of
    each row (every row masks as many)."""
    n = masked.shape[1]
    pos = torch.arange(n, device=masked.device).expand_as(masked)
    nm = int(masked[0].sum())
    vis = pos[~masked].reshape(masked.shape[0], n - nm)
    msk = pos[masked].reshape(masked.shape[0], nm)
    return vis, msk


def _block_size(u: float, height: int, width: int, scale, ar_range) -> tuple[int, int]:
    s = scale[0] + u * (scale[1] - scale[0])
    keep = int(height * width * s)
    ar = ar_range[0] + u * (ar_range[1] - ar_range[0])
    h, w = int(round(math.sqrt(keep * ar))), int(round(math.sqrt(keep / ar)))
    while h >= height:
        h -= 1
    while w >= width:
        w -= 1
    return h, w


def _cap(height: int, width: int, scale, ar_range) -> int:
    return max(h * w for h, w in (_block_size(u, height, width, scale, ar_range)
                                  for u in np.linspace(0.0, 1.0, 257)))


def _block(rng: np.random.Generator, size, height: int, width: int, min_keep: int,
           regions=None):
    h, w = size
    min_keep = min(min_keep, h * w - 1)
    tries, timeout = 0, 20
    while True:
        top = int(rng.integers(0, height - h))
        left = int(rng.integers(0, width - w))
        m = np.zeros((height, width), np.int32)
        m[top:top + h, left:left + w] = 1
        if regions is not None:
            for r in regions[:max(len(regions) - tries, 0)]:
                m *= r
        idx = np.nonzero(m.flatten())[0]
        if len(idx) > min_keep:
            break
        timeout -= 1
        if timeout == 0:
            tries, timeout = tries + 1, 20
    outside = np.ones((height, width), np.int32)
    outside[top:top + h, left:left + w] = 0
    return idx, outside


def multiblock(seed: int, step: int, rows: int, grid: tuple[int, int, int], mask: dict
               ) -> tuple[np.ndarray, np.ndarray]:
    """``(enc_idx [rows, Ke], pred_idx [rows, M, Kp])`` token indices of one
    collator step, -1 padded."""
    t, height, width = grid
    ar, npred = tuple(mask["aspect_ratio"]), mask["num_pred_masks"]
    enc_scale, pred_scale = tuple(mask["enc_mask_scale"]), tuple(mask["pred_mask_scale"])
    pred_cap, enc_cap = _cap(height, width, pred_scale, ar), _cap(height, width, enc_scale,
                                                                  (1.0, 1.0))
    size_rng = np.random.default_rng((seed, step))
    loc_rng = np.random.default_rng((seed, step, 1))
    p_size = _block_size(float(size_rng.random()), height, width, pred_scale, ar)
    e_size = _block_size(float(size_rng.random()), height, width, enc_scale, (1.0, 1.0))
    preds, encs = [], []
    for _ in range(rows):
        ps, outs = [], []
        for _ in range(npred):
            idx, out = _block(loc_rng, p_size, height, width, mask["min_keep"])
            ps.append(idx)
            outs.append(out)
        preds.append(ps)
        encs.append(_block(loc_rng, e_size, height, width, mask["min_keep"],
                           None if mask["allow_overlap"] else outs)[0])
    kp = min(len(i) for ps in preds for i in ps)
    ke = min(len(i) for i in encs)
    enc = np.full((rows, enc_cap), -1, np.int64)
    pred = np.full((rows, npred, pred_cap), -1, np.int64)
    last = (t - 1) * height * width
    for b in range(rows):
        enc[b, :ke] = encs[b][:ke]
        for m in range(npred):
            pred[b, m, :kp] = preds[b][m][:kp] + last
    return enc, pred
