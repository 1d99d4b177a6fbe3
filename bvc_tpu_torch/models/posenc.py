"""Fixed positional tables (counterpart of :mod:`bvc_tpu.models.posenc`).

Only the VideoMAE table is ported so far; the JEPA 3-D and image 2-D tables
come with their slices.
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
