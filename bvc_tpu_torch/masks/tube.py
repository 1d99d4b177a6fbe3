"""Tube and random masks for VideoMAE pretraining, drawn on the device.

Counterpart of :mod:`bvc_tpu.masks.tube`.  Masks come from a
``torch.Generator`` on the device of the step: one row of uniform draws per
sample, argsorted into a permutation, so a batch costs no host work and no
host-to-device copy.  The draws differ from ``jax.random``'s for any seed;
tests that compare the two packages hand both the same mask.

- tube: ``int(mask_ratio * H*W)`` of the ``H*W`` spatial patches of each
  sample, the same ones in every one of the T temporal sheets;
- random: ``int(mask_ratio * T*H*W)`` patches drawn uniformly over the
  whole token grid.

Both give every sample the same masked count, so the encoder's visible
token count is fixed.
"""

from __future__ import annotations

import torch


def _first_of_permutations(generator: torch.Generator, batch_size: int, n: int,
                           k: int) -> torch.Tensor:
    """``[B, n]`` bool, True at the first ``k`` entries of one random
    permutation of ``range(n)`` per row."""
    device = generator.device
    order = torch.rand((batch_size, n), generator=generator, device=device).argsort(dim=1)
    mask = torch.zeros((batch_size, n), dtype=torch.bool, device=device)
    return mask.scatter_(1, order[:, :k], True)


def tube_mask(generator: torch.Generator, batch_size: int, grid: tuple[int, int, int],
              mask_ratio: float) -> torch.Tensor:
    """``[B, T*H*W]`` bool mask (True = masked), one spatial pattern per
    sample repeated across its T sheets."""
    t, h, w = grid
    frame = _first_of_permutations(generator, batch_size, h * w, int(mask_ratio * h * w))
    return frame.repeat(1, t)


def random_mask(generator: torch.Generator, batch_size: int, grid: tuple[int, int, int],
                mask_ratio: float) -> torch.Tensor:
    """``[B, T*H*W]`` bool mask with uniformly random masked positions."""
    t, h, w = grid
    n = t * h * w
    return _first_of_permutations(generator, batch_size, n, int(mask_ratio * n))


def mask_partition(mask: torch.Tensor, num_visible: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a ``[B, N]`` bool mask into (visible_idx ``[B, V]``,
    masked_idx ``[B, N-V]``), each in ascending position order: a stable
    argsort of the 0/1 mask puts the visible positions first, the order HF
    VideoMAE's decoder assumes when it concatenates [visible ‖ mask
    tokens]."""
    order = torch.argsort(mask.to(torch.int32), dim=1, stable=True)
    return order[:, :num_visible], order[:, num_visible:]
