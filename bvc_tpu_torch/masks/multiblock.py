"""Multi-block mask collator for (V-)JEPA pretraining.

Counterpart of :mod:`bvc_tpu.masks.multiblock` (numpy, a copy: the port
imports nothing of ``bvc_tpu``): the same seeds and steps give the same
indices.  Behaviour of the reference ``MaskCollator``
(``pretraining/predictive/mask.py:69-219``) with static output shapes:
masks are index arrays padded with ``-1`` to fixed caps computed from the
scale and aspect-ratio ranges, and the model consumes them with attention
key masks and masked losses.

- One (h, w) block size per batch for the prediction and for the context
  masks, from a generator seeded by (seed, step); one uniform draw sets
  both the scale and the aspect ratio;
- per-sample block locations: ``npred`` prediction masks, then ``nenc``
  context masks whose acceptable region excludes the prediction blocks
  unless ``allow_overlap``;
- rejection sampling with the 20-try timeout that drops constraints one by
  one, and the strict ``len(mask) > min_keep`` test;
- truncation to the batch's shortest mask before padding, so every sample
  has the same valid count.

:func:`update_mask_indices` lifts frame-plane indices into the token grid:
context masks on sheet 0, prediction masks on the last sheet.
:func:`mask_collate` builds both from a run's configuration.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


def _block_size_from_u(u: float, height: int, width: int,
                       scale: tuple[float, float],
                       ar_range: tuple[float, float]) -> tuple[int, int]:
    """Reference ``_sample_block_size``: one uniform draw drives both the
    mask scale and the aspect ratio."""
    min_s, max_s = scale
    mask_scale = min_s + u * (max_s - min_s)
    max_keep = int(height * width * mask_scale)
    min_ar, max_ar = ar_range
    ar = min_ar + u * (max_ar - min_ar)
    h = int(round(math.sqrt(max_keep * ar)))
    w = int(round(math.sqrt(max_keep / ar)))
    while h >= height:
        h -= 1
    while w >= width:
        w -= 1
    return h, w


def _max_block_area(height: int, width: int, scale, ar_range) -> int:
    areas = (_block_size_from_u(u, height, width, scale, ar_range)
             for u in np.linspace(0.0, 1.0, 257))
    return max(h * w for h, w in areas)


@dataclass
class MultiBlockMaskCollator:
    """Callable producing ``(enc_idx, pred_idx)`` for a batch.

    Outputs:
      enc_idx  int32 ``[nenc,  B, enc_cap]``  (-1 padded)
      pred_idx int32 ``[npred, B, pred_cap]`` (-1 padded)
    """

    input_size: int = 224
    patch_size: int = 16
    enc_mask_scale: tuple[float, float] = (0.85, 1.0)
    pred_mask_scale: tuple[float, float] = (0.15, 0.2)
    aspect_ratio: tuple[float, float] = (0.75, 1.5)
    nenc: int = 1
    npred: int = 4
    min_keep: int = 10
    allow_overlap: bool = False
    seed: int = 0
    _step: int = field(default=-1)

    def __post_init__(self):
        self.height = self.input_size // self.patch_size
        self.width = self.input_size // self.patch_size
        self.pred_cap = _max_block_area(self.height, self.width, self.pred_mask_scale,
                                        self.aspect_ratio)
        self.enc_cap = _max_block_area(self.height, self.width, self.enc_mask_scale,
                                       (1.0, 1.0))
        if self.pred_cap < 1 or self.enc_cap < 1:
            raise ValueError(
                f"mask caps degenerate (enc_cap={self.enc_cap}, "
                f"pred_cap={self.pred_cap}) on a {self.height}x{self.width} "
                f"patch grid: scale ranges enc={self.enc_mask_scale} / "
                f"pred={self.pred_mask_scale} select zero-token blocks; "
                "lower patch_size, raise image_size, or widen the scales")

    def step(self) -> int:
        """Advance the shared counter."""
        self._step += 1
        return self._step

    def state_dict(self) -> dict:
        return {"step": self._step, "seed": self.seed}

    def load_state_dict(self, d: dict) -> None:
        self._step = int(d["step"])
        self.seed = int(d.get("seed", self.seed))

    def _sample_block_mask(self, rng: np.random.Generator, b_size,
                           acceptable_regions=None):
        h, w = b_size
        # a block of h*w <= min_keep tokens could never pass the strict
        # len(mask) > min_keep test: cap min_keep so the loop ends
        min_keep = min(self.min_keep, h * w - 1)
        tries, timeout = 0, 20
        while True:
            top = int(rng.integers(0, self.height - h))
            left = int(rng.integers(0, self.width - w))
            mask = np.zeros((self.height, self.width), np.int32)
            mask[top: top + h, left: left + w] = 1
            if acceptable_regions is not None:
                for k in range(max(len(acceptable_regions) - tries, 0)):
                    mask *= acceptable_regions[k]
            idx = np.nonzero(mask.flatten())[0]
            if len(idx) > min_keep:
                break
            timeout -= 1
            if timeout == 0:
                tries += 1
                timeout = 20
        complement = np.ones((self.height, self.width), np.int32)
        complement[top: top + h, left: left + w] = 0
        return idx.astype(np.int32), complement

    def __call__(self, batch_size: int, step: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
        """``step`` overrides the internal counter (a trainer derives it
        from (epoch, batch index), so masks do not depend on prefetch)."""
        seed_step = self.step() if step is None else int(step)
        size_rng = np.random.default_rng((self.seed, seed_step))
        loc_rng = np.random.default_rng((self.seed, seed_step, 1))

        # two independent draws, one per reference _sample_block_size call
        p_size = _block_size_from_u(float(size_rng.random()), self.height, self.width,
                                    self.pred_mask_scale, self.aspect_ratio)
        e_size = _block_size_from_u(float(size_rng.random()), self.height, self.width,
                                    self.enc_mask_scale, (1.0, 1.0))

        preds: list[list[np.ndarray]] = []
        encs: list[list[np.ndarray]] = []
        min_kp = min_ke = self.height * self.width
        for _ in range(batch_size):
            ms_p, complements = [], []
            for _ in range(self.npred):
                idx, comp = self._sample_block_mask(loc_rng, p_size)
                ms_p.append(idx)
                complements.append(comp)
                min_kp = min(min_kp, len(idx))
            preds.append(ms_p)
            acceptable = None if self.allow_overlap else complements
            ms_e = []
            for _ in range(self.nenc):
                idx, _ = self._sample_block_mask(loc_rng, e_size, acceptable)
                ms_e.append(idx)
                min_ke = min(min_ke, len(idx))
            encs.append(ms_e)

        pred_out = np.full((self.npred, batch_size, self.pred_cap), -1, np.int32)
        enc_out = np.full((self.nenc, batch_size, self.enc_cap), -1, np.int32)
        for b in range(batch_size):
            for m in range(self.npred):
                pred_out[m, b, :min_kp] = preds[b][m][:min_kp]
            for m in range(self.nenc):
                enc_out[m, b, :min_ke] = encs[b][m][:min_ke]
        return enc_out, pred_out


def update_mask_indices(masks: np.ndarray, image_size: int, patch_size: int,
                        num_frames: int, tubelet_size: int, isencoder: bool) -> np.ndarray:
    """Lift frame-plane indices to the token grid (sheet 0 for the encoder,
    the last sheet for the predictor); -1 padding is kept."""
    t = num_frames // tubelet_size
    per_frame = (image_size // patch_size) ** 2
    offset = 0 if isencoder else (t - 1) * per_frame
    return np.where(masks >= 0, masks + offset, masks)


def mask_collate(model_cfg, mask_cfg, seed: int = 0):
    """The collator of a JEPA run from its ``ModelConfig`` and
    ``MaskConfig`` (the counterpart of the JAX trainer's
    ``make_mask_collate``).  Returns ``collate(batch_size, step) ->
    {"enc_idx" [B, Ke], "pred_idx" [B, M, Kp]}``, token indices lifted by
    :func:`update_mask_indices`, batch-major as the train step takes them;
    ``collate.collator`` is the :class:`MultiBlockMaskCollator`."""
    if mask_cfg.num_enc_masks != 1:
        raise NotImplementedError("nenc != 1 is not supported (the reference always uses 1)")
    m = model_cfg
    collator = MultiBlockMaskCollator(
        input_size=m.image_size, patch_size=m.patch_size,
        enc_mask_scale=tuple(mask_cfg.enc_mask_scale),
        pred_mask_scale=tuple(mask_cfg.pred_mask_scale),
        aspect_ratio=tuple(mask_cfg.aspect_ratio), nenc=mask_cfg.num_enc_masks,
        npred=mask_cfg.num_pred_masks, min_keep=mask_cfg.min_keep,
        allow_overlap=mask_cfg.allow_overlap, seed=seed)

    def collate(batch_size: int, step: int) -> dict[str, np.ndarray]:
        enc, pred = collator(batch_size, step=step)
        lift = (m.image_size, m.patch_size, m.num_frames, m.tubelet_size)
        return {"enc_idx": update_mask_indices(enc, *lift, isencoder=True)[0],
                "pred_idx": update_mask_indices(pred, *lift, isencoder=False)
                .transpose(1, 0, 2)}

    collate.collator = collator
    return collate
