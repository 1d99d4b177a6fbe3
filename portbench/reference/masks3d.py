"""V-JEPA's 3-D multi-block masks of a training step, worked out again from
the seed (the released ``_MaskGenerator``, ``src/masks/multiblock3d.py``, at
a temporal scale of 1, seeded as the benchmark's other collator copy is):

- a numpy generator seeded ``(seed, step)``; its first draw sets the spatial
  scale within ``pred_mask_scale`` (``keep = int(H * W * scale)``), its
  second the aspect ratio ``ar`` within ``aspect_ratio``; the blocks are
  ``round(sqrt(keep * ar))`` rows by ``round(sqrt(keep / ar))`` columns,
  each at most the grid's;
- per clip ``pred_num_blocks`` corners, top then left, each uniform over
  the places where the block fits; the blocks' union, in every temporal
  sheet, is the target; a clip whose union covers the whole sheet is drawn
  again;
- the context ids and the target ids in ascending order, every clip's cut
  to the batch's smallest count.
"""

from __future__ import annotations

import math

import numpy as np


def multiblock3d(seed: int, step: int, rows: int, grid: tuple[int, int, int], mask: dict
                 ) -> tuple[np.ndarray, np.ndarray]:
    """``(enc [rows, Ke], pred [rows, Kp])`` int64 token ids of one step."""
    t, height, width = grid
    rng = np.random.default_rng((seed, step))
    lo, hi = mask["pred_mask_scale"]
    keep = int(height * width * (lo + rng.random() * (hi - lo)))
    a_lo, a_hi = mask["aspect_ratio"]
    ar = a_lo + rng.random() * (a_hi - a_lo)
    h = min(int(round(math.sqrt(keep * ar))), height)
    w = min(int(round(math.sqrt(keep / ar))), width)
    encs, preds = [], []
    for _ in range(rows):
        while True:
            sheet = np.zeros((height, width), bool)
            for _ in range(mask["pred_num_blocks"]):
                top = int(rng.integers(0, height - h + 1))
                left = int(rng.integers(0, width - w + 1))
                sheet[top:top + h, left:left + w] = True
            if not sheet.all():
                break
        ids = np.arange(t * height * width)
        target = np.tile(sheet.reshape(-1), t)
        encs.append(ids[~target])
        preds.append(ids[target])
    ke, kp = min(len(e) for e in encs), min(len(p) for p in preds)
    return (np.stack([e[:ke] for e in encs]).astype(np.int64),
            np.stack([p[:kp] for p in preds]).astype(np.int64))
