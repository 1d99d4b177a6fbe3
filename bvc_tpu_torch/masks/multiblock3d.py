"""V-JEPA's 3-D multi-block mask collator (numpy, on the host).

V-JEPA and V-JEPA 2 (Bardes et al. 2024; Assran et al. 2025) mask tubes
through the whole clip: the targets of a clip are the union of
``num_blocks`` spatial blocks, each covering every time step, and the
context is everything else.  The behaviour of the released ``_MaskGenerator``
(``src/masks/multiblock3d.py``) at a temporal scale of 1, with the port's
seeding (a numpy generator of ``(seed, step)``, as
:mod:`bvc_tpu_torch.masks.multiblock`):

- one block size per batch: a uniform draw sets the spatial scale
  (``num_keep = int(H * W * scale)``), a second one the aspect ratio ``ar``;
  ``h = round(sqrt(num_keep * ar))``, ``w = round(sqrt(num_keep / ar))``,
  each capped at the grid;
- per clip, ``num_blocks`` block corners drawn uniformly (``top`` in ``0 ..
  H - h``, ``left`` in ``0 .. W - w``), the union marked in every temporal
  sheet; a draw that leaves no context is drawn again;
- the context ids (ascending, of the ``T * H * W`` grid) and the target ids,
  each clip's cut to the batch's smallest count, so every clip of a batch
  keeps as many: no padding, and a batch's microbatches hold equal shares.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def block_size(u_scale: float, u_ar: float, height: int, width: int,
               scale: tuple[float, float], ar_range: tuple[float, float]) -> tuple[int, int]:
    """``(h, w)`` of the batch's blocks from the two uniform draws."""
    s = scale[0] + u_scale * (scale[1] - scale[0])
    keep = int(height * width * s)
    ar = ar_range[0] + u_ar * (ar_range[1] - ar_range[0])
    h = int(round(math.sqrt(keep * ar)))
    w = int(round(math.sqrt(keep / ar)))
    return min(h, height), min(w, width)


@dataclass
class MultiBlock3DMaskCollator:
    """Callable producing ``(enc_idx [B, Ke], pred_idx [B, Kp])`` int32 token
    ids of one collator step on a ``grid = (T, H, W)``."""

    grid: tuple[int, int, int]
    scale: tuple[float, float] = (0.15, 0.15)
    aspect_ratio: tuple[float, float] = (0.75, 1.5)
    num_blocks: int = 8
    seed: int = 0
    last_step: int = -1

    def state_dict(self) -> dict:
        return {"step": self.last_step, "seed": self.seed}

    def __call__(self, batch_size: int, step: int) -> tuple[np.ndarray, np.ndarray]:
        T, H, W = self.grid
        self.last_step = int(step)
        rng = np.random.default_rng((self.seed, int(step)))
        h, w = block_size(float(rng.random()), float(rng.random()), H, W, self.scale,
                          self.aspect_ratio)
        encs, preds = [], []
        for _ in range(batch_size):
            while True:
                covered = np.zeros((H, W), bool)
                for _ in range(self.num_blocks):
                    top = int(rng.integers(0, H - h + 1))
                    left = int(rng.integers(0, W - w + 1))
                    covered[top:top + h, left:left + w] = True
                if not covered.all():
                    break
            tube = np.broadcast_to(covered, (T, H, W)).reshape(-1)
            encs.append(np.flatnonzero(~tube))
            preds.append(np.flatnonzero(tube))
        ke, kp = min(map(len, encs)), min(map(len, preds))
        return (np.stack([e[:ke] for e in encs]).astype(np.int32),
                np.stack([p[:kp] for p in preds]).astype(np.int32))


def mask_collate_3d(model_cfg, mask_cfg, seed: int = 0):
    """The 3-D collator of a JEPA run from its ``ModelConfig`` and
    ``MaskConfig`` (``sampler='multiblock3d'``: ``pred_mask_scale`` the
    blocks' spatial scale range, ``aspect_ratio``, ``pred_num_blocks``; one
    prediction mask).  Returns ``collate(batch_size, step) -> {"enc_idx" [B,
    Ke], "pred_idx" [B, 1, Kp]}`` as the train step takes them;
    ``collate.collator`` is the :class:`MultiBlock3DMaskCollator`."""
    if mask_cfg.num_pred_masks != 1:
        raise ValueError(f"the 3-D collator makes one prediction mask (the blocks' union), "
                         f"got num_pred_masks={mask_cfg.num_pred_masks}")
    m = model_cfg
    g = m.image_size // m.patch_size
    collator = MultiBlock3DMaskCollator(
        grid=(m.num_frames // m.tubelet_size, g, g), scale=tuple(mask_cfg.pred_mask_scale),
        aspect_ratio=tuple(mask_cfg.aspect_ratio), num_blocks=mask_cfg.pred_num_blocks,
        seed=seed)

    def collate(batch_size: int, step: int) -> dict[str, np.ndarray]:
        enc, pred = collator(batch_size, step)
        return {"enc_idx": enc, "pred_idx": pred[:, None]}

    collate.collator = collator
    return collate
