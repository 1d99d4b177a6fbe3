"""Fixed positional tables (counterpart of :mod:`bvc_tpu.models.posenc`).

- :func:`sinusoid_table_1d`, VideoMAE's;
- :func:`positional_encoding_3d`, the JEPA video ViT's, with the channel
  partition of the reference's ``PositionalEncoding3D``;
- :func:`interpolate_pos_table_3d`, that table resized bicubically to
  another spatial grid (torch's ``interpolate`` semantics, in numpy);
- :func:`sincos_2d`, the image ViT's 2-D table, and
  :func:`interpolate_pos_table`, a square-grid table resized bicubically
  to another number of patches.
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


def _sincos_1d_halves(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """``[len(pos), embed_dim]`` with first half all-sin, second half
    all-cos (``get_1d_sincos_pos_embed_from_grid``,
    ``predictive/vision_transformer.py:124-142``)."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim {embed_dim} must be even")
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(embed_dim: int, grid_size: int, cls_token: bool = False) -> np.ndarray:
    """``[grid^2 (+1), embed_dim]`` image-ViT table
    (``get_2d_sincos_pos_embed``, ``:82-108``): positions flattened
    row-major (h slow, w fast); the first half of the channels encodes the
    w coordinate (the reference's ``meshgrid(grid_w, grid_h)`` puts the
    w-grid in ``grid[0]``, which its ``emb_h`` then consumes)."""
    coords = np.arange(grid_size, dtype=np.float64)
    grid_w, grid_h = np.meshgrid(coords, coords)  # h slow, w fast
    emb_first = _sincos_1d_halves(embed_dim // 2, grid_w)
    emb_second = _sincos_1d_halves(embed_dim // 2, grid_h)
    table = np.concatenate([emb_first, emb_second], axis=1)
    if cls_token:
        table = np.concatenate([np.zeros((1, embed_dim)), table], axis=0)
    return table.astype(np.float32)


def _cubic_weights(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic-convolution weights ``[len(t), 4]`` for the 4-tap kernel at
    fractional offset ``t`` (Keys kernel, torch's a=-0.75)."""
    def k(x):
        x = np.abs(x)
        return np.where(
            x <= 1.0,
            ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
            np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
        )
    return np.stack([k(t + 1.0), k(t), k(1.0 - t), k(2.0 - t)], axis=-1)


def _bicubic_axis(x: np.ndarray, out_size: int, scale: float) -> np.ndarray:
    """Resize axis 0 of ``x`` with torch's bicubic semantics
    (``align_corners=False``: src = (dst + 0.5) / scale − 0.5, 4-tap Keys
    kernel a=−0.75, borders clamped)."""
    in_size = x.shape[0]
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) / scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    w = _cubic_weights(t)  # [out, 4]
    taps = np.stack(
        [np.clip(i0 + d, 0, in_size - 1) for d in (-1, 0, 1, 2)], axis=-1
    )  # [out, 4]
    gathered = x[taps.reshape(-1)].reshape(out_size, 4, *x.shape[1:])
    w = w.reshape(out_size, 4, *([1] * (x.ndim - 1)))
    return np.sum(gathered * w, axis=1)


def bicubic_resize_2d(grid: np.ndarray, scale_factor: float,
                      out_hw: tuple[int, int] | None = None,
                      scale_w: float | None = None) -> np.ndarray:
    """``[H, W, D] → [out_h, out_w, D]`` replicating
    ``torch.nn.functional.interpolate(mode='bicubic', align_corners=False,
    scale_factor=sf)``: source coordinates mapped with the *given* scale
    factor (torch keeps the provided scale when ``recompute_scale_factor``
    is unset), golden-tested against torch in ``tests/test_posenc.py``.

    ``out_hw`` defaults to torch's ``floor(dim * sf)`` but callers that
    know the exact target pass it explicitly — ``int(H * sf)`` silently
    truncates one row for many valid targets (e.g. ``14 * (61/14)`` →
    60.999… → 60), a float pitfall the upstream DINO code dodges by
    adding 0.1 to the scale.  ``scale_w`` allows a distinct width scale
    (non-uniform resizes)."""
    H, W, _ = grid.shape
    sw = scale_factor if scale_w is None else scale_w
    out_h, out_w = out_hw or (int(H * scale_factor), int(W * sw))
    out = _bicubic_axis(grid.astype(np.float64), out_h, scale_factor)
    out = np.moveaxis(
        _bicubic_axis(np.moveaxis(out, 1, 0), out_w, sw), 0, 1
    )
    return out


def interpolate_pos_table(table: np.ndarray, npatch: int,
                          cls_token: bool = False) -> np.ndarray:
    """Bicubically resize a square-grid position table to ``npatch``
    positions, the reference's ``interpolate_pos_encoding``
    (``pretraining/predictive/vision_transformer_image.py:426-440``): strip
    the cls row if present, reshape the rest to its sqrt(N) square grid,
    resize by ``scale_factor=sqrt(npatch/N)`` bicubic, flatten, re-prepend
    cls.  ``table``: ``[N(+1), D]``.  Returns ``[npatch(+1), D]`` float32;
    raises unless both N and ``npatch`` are squares."""
    cls_row = None
    if cls_token:
        cls_row, table = table[:1], table[1:]
    n = table.shape[0]
    if npatch == n:
        out = table
    else:
        g = int(np.sqrt(n))
        g_new = int(round(np.sqrt(npatch)))
        if g * g != n or g_new * g_new != npatch:
            raise ValueError(f"pos table of {n} rows and target {npatch} patches must "
                             "both be square grids")
        out = bicubic_resize_2d(
            table.reshape(g, g, -1), float(np.sqrt(npatch / n)), out_hw=(g_new, g_new),
        ).reshape(-1, table.shape[-1])
    if cls_row is not None:
        out = np.concatenate([cls_row, out], axis=0)
    return out.astype(np.float32)


def interpolate_pos_table_3d(table: np.ndarray, t: int, h: int, w: int,
                             new_h: int, new_w: int) -> np.ndarray:
    """Spatially resize a ``[t*h*w, D]`` video position table to
    ``[t*new_h*new_w, D]`` (bicubic per time slice).

    The reference's video ViT routes through the same 2-D
    ``interpolate_pos_encoding`` (``vision_transformer.py:388,404-418``),
    which treats token 0 as a class embedding and assumes a square
    ``sqrt(N)`` grid — latently broken for ``t*h*w`` video tables (it can
    only ever hit its ``npatch == N`` early-return in the shipped
    configs).  This implements the evident intent: per-time-slice spatial
    bicubic with the same torch kernel semantics.
    """
    grid = table.reshape(t, h, w, -1).astype(np.float64)
    out = np.stack([
        bicubic_resize_2d(grid[i], new_h / h, out_hw=(new_h, new_w),
                          scale_w=new_w / w)
        for i in range(t)
    ])
    return out.reshape(t * new_h * new_w, -1).astype(np.float32)
