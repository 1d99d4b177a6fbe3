"""Pure index math of the data layer (a copy of
:mod:`bvc_tpu.data.indexing`; the port imports nothing of ``bvc_tpu``).

These functions decide *which* frames each run sees, so their semantics must
match the reference exactly for embeddings/scores to be comparable
(SURVEY.md §7 step 2).  All are pure and run on the host at dataset-build
time.

Reference implementations (behavioral spec, not copied):

- ``get_group``              pretraining/generative/homeview.py:170-193
- ``get_fpathlist``          pretraining/generative/homeview.py:92-103
- ``get_fold``               pretraining/generative/homeview.py:156-167
- ``get_train_val_split``    pretraining/generative/homeview.py:105-116
- ``get_fpathseqlist``       pretraining/generative/homeview.py:132-153
- ``get_fpath2framelist``    pretraining/generative/homeview.py:118-129
"""

from __future__ import annotations

import itertools
import random as _random
from pathlib import Path
from typing import Sequence, TypeVar

T = TypeVar("T")

# Hard-coded subject registry per age group.  g0 = youngest infants,
# g3 = adults (two-letter ids).  Reference: generative/homeview.py:172-175.
AGE_GROUPS: dict[str, tuple[str, ...]] = {
    "g0": tuple(
        "008MS 009SS 010BF 011EA 012TT 013LS 014SN 015JM 016TF 017EW".split()
    ),
    "g1": tuple(
        "026AR 027SS 028CK 028MR 029TT 030FD 031HW 032SR 033SE 034JC".split()
    ),
    "g2": tuple(
        "043MP 044ET 046TE 047MS 048KG 049JC 050AB 050AK 051DW".split()
    ),
    "g3": tuple("BR CW EA ED JB KI LS SB TR".split()),
}


def get_group(train_group: str, rng: _random.Random | None = None) -> list[str] | None:
    """Resolve a group key to its subject directories.

    ``'gr'`` samples 3 subjects from each of the four groups and shuffles
    the union (reference :186-189 — uses the global ``random`` module, which
    the trainers seed with ``args.seed``; pass ``rng`` for an isolated
    stream).
    """
    rng = rng or _random
    if train_group == "gr":
        g_rand: list[str] = []
        for key in ("g0", "g1", "g2", "g3"):
            g_rand.extend(rng.sample(list(AGE_GROUPS[key]), 3))
        rng.shuffle(g_rand)
        return g_rand
    group = AGE_GROUPS.get(train_group)
    return list(group) if group is not None else None


def get_fpathlist(vid_root: str, subjdir: str, ds_rate: int = 1) -> list[str]:
    """Sorted .jpg listing of one subject dir, temporally downsampled.

    Sort key is the file name; only ``.jpg`` files count; the stride
    ``[::ds_rate]`` applies after filtering (reference :99-102).
    """
    base = Path(vid_root) / subjdir
    fpaths = sorted(base.iterdir(), key=lambda p: p.name)
    fpaths = [str(p) for p in fpaths if p.suffix == ".jpg"]
    return fpaths[::ds_rate]


def get_fold(
    items: Sequence[T],
    fold: int,
    max_folds: int = 3,
    segment_size: int | None = None,
    ds_rate: int = 1,
) -> list[T]:
    """Round-robin contiguous 30-minute segments into folds; keep one fold.

    Segment i (of ``segment_size`` frames) belongs to fold
    ``i % max_folds``.  ``segment_size`` defaults to
    ``int(30*60*30/ds_rate)`` — 30 minutes at 30 fps divided by the
    temporal downsampling (reference :158).
    """
    if segment_size is None:
        segment_size = int(30 * 60 * 30 / ds_rate)
    segments = [
        items[i : i + segment_size]
        for i in range(0, len(items), segment_size)
        if (i // segment_size) % max_folds == fold
    ]
    return list(itertools.chain.from_iterable(segments))


def get_train_val_split(
    items: Sequence[T], val_ratio: float = 0.1
) -> tuple[list[T], list[T]]:
    """Temporally contiguous split: middle ``val_ratio`` slice is val,
    flanks are train (reference :105-116)."""
    n = len(items)
    val_size = int(n * val_ratio)
    split1 = int((n - val_size) / 2)
    split2 = int((n + val_size) / 2)
    train = list(items[:split1]) + list(items[split2:])
    val = list(items[split1:split2])
    return train, val


def get_fpathseqlist(
    items: Sequence[T],
    seq_len: int,
    ds_rate: int = 1,
    n_samples: int | None = None,
) -> list[list[T]]:
    """Clip sampling: stride-resampled windows of ``seq_len*ds_rate`` frames.

    With ``n_samples`` given, the stride is ``len(items)//n_samples`` so
    overlapping clips are allowed (each frame may appear in multiple clips
    at different positions — reference :147-149).
    """
    sample_len = seq_len * ds_rate
    if sample_len > len(items):
        raise ValueError(
            f"clip window ({seq_len}x{ds_rate}={sample_len} frames) exceeds "
            f"the corpus ({len(items)} frames)"
        )
    if n_samples is None:
        n_samples = int(len(items) / seq_len)
        sample_stride = sample_len
    else:
        if len(items) <= n_samples:
            raise ValueError(
                f"need more frames ({len(items)}) than samples ({n_samples})"
            )
        sample_stride = int(len(items) / n_samples)
    # Clamp window starts so every clip has full length.  (The reference's
    # slicing lets final windows run off the end and come back short when
    # n_samples*stride + window > len — a latent crash in torch.stack; at
    # its corpus/sample ratios it never triggers.  Clamping preserves the
    # stride pattern everywhere else and keeps shapes static under jit.)
    max_start = max(0, len(items) - sample_len)
    return [
        list(items[min(i, max_start) : min(i, max_start) + sample_len : ds_rate])
        for i in range(0, n_samples * sample_stride, sample_stride)
    ]


def get_fpath2framelist(
    items: Sequence[T],
    interval: int,
    n_samples: int | None = None,
) -> list[list[T]]:
    """Pair sampling: ``[frame_i, frame_{i+interval}]`` anchors, stride-
    subsampled to ``n_samples`` pairs.  ``interval`` is the slowness knob
    (e.g. 900 frames = 30 s at contrastive stage 1 — SURVEY.md §2.2).
    Reference :118-129."""
    if n_samples is None:
        n_samples = len(items) - interval - 1
        sample_stride = 1
    else:
        if len(items) < n_samples:
            raise ValueError(
                f"need at least {n_samples} frames, got {len(items)}"
            )
        sample_stride = int((len(items) - interval - 1) / n_samples)
    return [
        [items[i], items[i + interval]]
        for i in range(0, n_samples * sample_stride, sample_stride)
    ]
