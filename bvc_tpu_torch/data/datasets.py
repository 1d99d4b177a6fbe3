"""Map-style datasets over frame-path lists (a copy of
:mod:`bvc_tpu.data.datasets`, the same ``(idx, rng)`` protocol).

Functional analogues of the reference's torch Datasets
(``generative/homeview.py:236-374``, ``predictive/homeview.py:264-306``):
each dataset maps an index to a decoded, transformed numpy sample
(channels-last float32).  No torch dependency; decoding runs in the
loader's worker threads.

Sample shapes:

- ``ClipDataset``        → ``[T, H, W, 3]``     (ImageSequenceDataset)
- ``PairDataset``        → ``[2, H, W, 3]``     (TwoFrameDataset)
- ``TwoSeqDataset``      → ``[2*ts, H, W, 3]``  (two tubelets `interval` apart)
- ``StillVideoDataset``  → ``[16, H, W, 3]``    (1 frame repeated — the
  'static' control)
- ``ImageDataset``       → ``[H, W, 3]``

Each dataset counts the frames each read path served (``served``:
``packed``, ``native`` or ``python``), so a loader can say which one fed it.
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from bvc_tpu_torch.data.transforms import FrameTransform, decode_jpeg, normalize


class _Base:
    # Optional packed-corpus reader (bvc_tpu.data.packed.PackedCorpus),
    # attached post-construction by the factory when DataConfig.pack_root
    # is set.  Plain class attribute so the dataclass constructors stay
    # reference-shaped.
    reader = None

    def __post_init__(self):
        self.served: collections.Counter = collections.Counter()
        self._served_lock = threading.Lock()

    def _count(self, path: str, n: int = 1) -> None:
        with self._served_lock:
            self.served[path] += n

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx_and_rng) -> np.ndarray:
        raise NotImplementedError

    def _packed_ok(self) -> bool:
        """Packed rows are the plain stack's pre-normalize output at a
        fixed size — only substitutable when the transform IS that
        stack at that size."""
        return (
            self.reader is not None
            and self.transform.is_plain
            and self.transform.image_size == self.reader.image_size
            and self.transform.dct_scale == self.reader.dct_scale
        )

    def _finish(self, frames_u8: np.ndarray) -> np.ndarray:
        return frames_u8 if self.transform.output_uint8 else normalize(frames_u8)

    def _load(self, fp: str, rng: np.random.Generator) -> np.ndarray:
        if self._packed_ok():
            img = self.reader.get(fp)
            if img is not None:
                self._count("packed")
                return self._finish(img)
        self._count("python")
        return self.transform(decode_jpeg(fp), rng)

    def _load_seq(self, fps, rng: np.random.Generator) -> np.ndarray:
        """Load a frame sequence: packed memmap rows when a matching
        packed corpus is attached (no JPEG decode in the hot path —
        tools/pack_corpus.py), else the fused native decode
        (bvc_tpu.native) for plain transforms, else per-frame Python."""
        if self._packed_ok():
            seq = self.reader.get_seq(fps)
            if seq is not None:
                self._count("packed", len(seq))
                return self._finish(seq)
        if self.transform.is_plain:
            from bvc_tpu_torch import native

            if native.available():
                self._count("native", len(fps))
                return native.decode_frames(
                    list(fps), self.transform.image_size,
                    uint8=self.transform.output_uint8,
                    dct_scale=self.transform.dct_scale,
                )
        return np.stack([self._load(fp, rng) for fp in fps])


@dataclass
class ClipDataset(_Base):
    """T-frame clips; optional per-sample frame shuffling (the 'shuffle'
    temporal control, ``ImageSequenceDataset`` shuffle flag)."""

    seqlist: Sequence[Sequence[str]]
    transform: FrameTransform
    shuffle_frames: bool = False

    def __len__(self):
        return len(self.seqlist)

    def __getitem__(self, args):
        idx, rng = args
        frames = self._load_seq(self.seqlist[idx], rng)
        if self.shuffle_frames:
            frames = frames[rng.permutation(len(frames))]
        return frames


@dataclass
class PairDataset(_Base):
    """Anchor + positive frame pairs (``TwoFrameDataset``)."""

    pairlist: Sequence[Sequence[str]]
    transform: FrameTransform

    def __len__(self):
        return len(self.pairlist)

    def __getitem__(self, args):
        idx, rng = args
        return np.stack([self._load(fp, rng) for fp in self.pairlist[idx]])


@dataclass
class TwoSeqDataset(_Base):
    """Two ``seq_size``-frame tubelets ``interval`` frames apart over one
    flat frame list (``predictive/homeview.py:264-306``).  The second
    tubelet starts at ``idx - interval`` clamped exactly as the
    reference's ``safe_idx``."""

    fpathlist: Sequence[str]
    transform: FrameTransform
    interval: int
    seq_size: int

    def __len__(self):
        return len(self.fpathlist) - self.interval - self.seq_size

    def _safe_idx(self, idx: int) -> int:
        new_idx = idx - self.interval
        return idx if new_idx > len(self) else new_idx

    def __getitem__(self, args):
        idx, rng = args
        seq1 = [self._load(fp, rng) for fp in self.fpathlist[idx : idx + self.seq_size]]
        i2 = self._safe_idx(idx)
        seq2 = [self._load(fp, rng) for fp in self.fpathlist[i2 : i2 + self.seq_size]]
        return np.stack(seq1 + seq2)


@dataclass
class StillVideoDataset(_Base):
    """First frame of each seq repeated ``num_frames`` times — the
    'static' complexity control (``generative/homeview.py:356-374``)."""

    seqlist: Sequence[Sequence[str]]
    transform: FrameTransform
    num_frames: int = 16

    def __len__(self):
        return len(self.seqlist)

    def __getitem__(self, args):
        idx, rng = args
        frame = self._load(self.seqlist[idx][0], rng)
        return np.broadcast_to(frame, (self.num_frames,) + frame.shape).copy()


@dataclass
class ImageDataset(_Base):
    """Single frames (``generative/homeview.py:236-253``)."""

    seqlist: Sequence[Sequence[str]]
    transform: FrameTransform

    def __len__(self):
        return len(self.seqlist)

    def __getitem__(self, args):
        idx, rng = args
        return self._load(self.seqlist[idx][0], rng)
