"""The clips of a training step, worked out again from the corpus and the
seed, as the reference's data layer defines them (``generative/
homeview.py``, ``predictive/homeview.py``):

- the frame list is every subject's frames in name order, the subjects in
  their age group's order, one fold of 30-minute segments kept (a corpus
  shorter than a segment is fold 0 whole);
- a VideoMAE sample ``i`` is ``num_frames`` consecutive frames from
  ``min(i * stride, len - num_frames)``, ``stride = len // n_samples``;
- a V-JEPA sample ``i`` is the two frames ``i * stride`` and ``i * stride +
  interval``, ``stride = (len - interval - 1) // n_samples``;
- epoch ``e`` visits the samples in the order of
  ``numpy.random.default_rng((seed, e)).permutation(n_samples)``, in
  global batches, the last partial one dropped.

The corpus here is the benchmark's own (``portbench/corpus.py``): every
subject's shard holds the same seeded frames, so frame ``j`` of the list is
row ``j % frames_per_subject`` of them.
"""

from __future__ import annotations

import numpy as np


def sample_order(n: int, seed: int, epoch: int = 0) -> np.ndarray:
    return np.random.default_rng((seed, epoch)).permutation(n)


def batch_samples(n: int, global_batch: int, seed: int, step: int) -> np.ndarray:
    """Sample indices of global batch ``step`` of epoch 0."""
    if (step + 1) * global_batch > n:
        raise ValueError("the reference follows steps of the first epoch only")
    return sample_order(n, seed)[step * global_batch:(step + 1) * global_batch]


def clip_frames(frames: np.ndarray, total: int, samples: np.ndarray, num_frames: int,
                n_samples: int) -> np.ndarray:
    """``[B, num_frames, S, S, 3]`` uint8 VideoMAE clips; ``frames`` the
    shard shared by the subjects, ``total`` the frame list's length."""
    stride = total // n_samples
    starts = np.minimum(samples * stride, total - num_frames)
    rows = (starts[:, None] + np.arange(num_frames)[None, :]) % len(frames)
    return frames[rows]


def pair_frames(frames: np.ndarray, total: int, samples: np.ndarray, interval: int,
                n_samples: int) -> np.ndarray:
    """``[B, 2, S, S, 3]`` uint8 V-JEPA pairs ``interval`` frames apart."""
    stride = (total - interval - 1) // n_samples
    first = samples * stride
    rows = np.stack([first, first + interval], axis=1) % len(frames)
    return frames[rows]
