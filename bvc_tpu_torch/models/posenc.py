"""Fixed positional tables (counterpart of :mod:`bvc_tpu.models.posenc`).

- :func:`sinusoid_table_1d`, VideoMAE's;
- :func:`positional_encoding_3d`, the JEPA video ViT's, with the channel
  partition of the reference's ``PositionalEncoding3D``.

Resizing a table to another spatial grid (``interpolate_pos_table_3d``) and
the image ViT's 2-D table come with later slices (ROADMAP).
"""

from __future__ import annotations

import numpy as np


def sinusoid_table_1d(n_position: int, d_hid: int) -> np.ndarray:
    """``[n_position, d_hid]`` HF-VideoMAE sinusoid table: shared angle
    vector ``pos / 10000^(2*(j//2)/d)``, sin on even j, cos on odd j."""
    j = np.arange(d_hid)
    angle_rates = 1.0 / np.power(10000.0, 2 * (j // 2) / d_hid)
    table = np.arange(n_position, dtype=np.float64)[:, None] * angle_rates[None, :]
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return table.astype(np.float32)


def _interleaved_sincos(pos: np.ndarray, inv_freq: np.ndarray) -> np.ndarray:
    """``[len(pos), 2*len(inv_freq)]`` with channels (sin0, cos0, sin1, ...)."""
    angles = np.einsum("i,j->ij", pos, inv_freq)
    out = np.stack([np.sin(angles), np.cos(angles)], axis=-1)
    return out.reshape(len(pos), -1)


def positional_encoding_3d(t: int, h: int, w: int, channels: int) -> np.ndarray:
    """``[t*h*w, channels]`` table of the reference's
    ``PositionalEncoding3D`` on a ``(t, h, w)`` grid, flattened row-major
    (t slowest, w fastest): the channels split into three blocks of
    ``ceil(C/6)*2`` for t, y and x, each of interleaved (sin, cos) pairs,
    the last block cut back to C."""
    block = int(np.ceil(channels / 6) * 2)
    if block % 2:
        block += 1
    inv_freq = 1.0 / (10000 ** (np.arange(0, block, 2, dtype=np.float64) / block))

    emb_t = _interleaved_sincos(np.arange(t, dtype=np.float64), inv_freq)
    emb_y = _interleaved_sincos(np.arange(h, dtype=np.float64), inv_freq)
    emb_x = _interleaved_sincos(np.arange(w, dtype=np.float64), inv_freq)

    table = np.zeros((t, h, w, block * 3), dtype=np.float64)
    table[..., :block] = emb_t[:, None, None, :]
    table[..., block: 2 * block] = emb_y[None, :, None, :]
    table[..., 2 * block:] = emb_x[None, None, :, :]
    return table[..., :channels].reshape(t * h * w, channels).astype(np.float32)
