"""Tubelet patch embedding as one matrix product.

Counterpart of :mod:`bvc_tpu.ops.patchify`.  A Conv3d whose stride equals
its kernel ``(ts, p, p)`` is a blocked reshape followed by a dense
projection.  Video layout is ``[B, T, H, W, C]``; the flat patch axis
iterates (c, dt, dh, dw) slowest to fastest, the order of a torch Conv3d
weight ``[D, C, ts, p, p]`` flattened.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def patchify_pixels(video: torch.Tensor, tubelet_size: int,
                    patch_size: int) -> torch.Tensor:
    """``[B, T, H, W, C] -> [B, N, C*ts*p*p]`` tubelet pixel blocks, tokens
    ordered time-major then row-major over the spatial grid."""
    B, T, H, W, C = video.shape
    ts, p = tubelet_size, patch_size
    x = video.reshape(B, T // ts, ts, H // p, p, W // p, p, C)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)  # [B, T/ts, H/p, W/p, C, ts, p, p]
    return x.reshape(B, (T // ts) * (H // p) * (W // p), C * ts * p * p)


def tubelet_patchify(video: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor | None, tubelet_size: int,
                     patch_size: int, dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """``patchify_pixels`` then one dense projection in ``dtype``.

    ``weight`` is ``[D, C*ts*p*p]`` (the ``nn.Linear`` layout, the transpose
    of the JAX kernel), ``bias`` ``[D]``.  Returns ``[B, N, D]``."""
    patches = patchify_pixels(video, tubelet_size, patch_size).to(dtype)
    return F.linear(patches, weight.to(dtype),
                    None if bias is None else bias.to(dtype))
