"""Frozen arithmetic of the Hiera cell's metrics: the model operations of a
Hiera MAE training step a clip and the least time of the decoder's
attention at head width 32.  Kept beside the benchmark (and not read from
the program) so that a change to the program cannot move the yardstick;
``portbench/arith.py`` holds the peaks and the attention bounds.

A configuration is the ``model`` mapping of ``configs/hiera_h_mae.json``
(the program's ``ModelConfig`` field names).
"""

from __future__ import annotations

import math
from typing import Mapping

from portbench import arith


def kept_units(m: Mapping, mask_ratio: float) -> int:
    """Mask units a clip keeps: ``int(n (1 - ratio))`` of the ``n``."""
    grid = (m["num_frames"] // m["tubelet_size"], m["image_size"] // m["patch_size"],
            m["image_size"] // m["patch_size"])
    n = math.prod(g // u for g, u in zip(grid, m["mask_unit_size"]))
    return int(n * (1 - mask_ratio))


def encoder_flops(m: Mapping, units: int) -> tuple[int, list[int]]:
    """Forward operations of the encoder's blocks over ``units`` kept units
    a clip, and each stage's output tokens.  A block from width ``a`` to
    ``b`` over ``n`` tokens in, ``n'`` out (``n' = n / q`` where its queries
    pool by ``q``): the width change ``2 n a b``, qkv ``6 n a b``, the
    attention ``4 q_w k_w b`` a window (``q_w``, ``k_w`` its queries and
    keys; one window over every token where it attends globally), the
    projection ``2 n' b^2``, the MLP ``4 n' b f`` (f = mlp_ratio b)."""
    per_unit = math.prod(m["mask_unit_size"])
    q_area = math.prod(m["q_stride"])
    n, dim, total, outs = units * per_unit, m["hidden_size"], 0, []
    for s, depth in enumerate(m["stage_depths"]):
        out = int(m["hidden_size"] * m["dim_mul"] ** s)
        lag = s > 0 and m["mask_unit_attn"][s - 1]
        for i in range(depth):
            q = q_area if i == 0 and 0 < s <= m["q_pool"] else 1
            n_out = n // q
            if dim != out:
                total += 2 * n * dim * out
            total += 6 * n * dim * out
            windows = units if m["mask_unit_attn"][s] or (lag and i == 0) else 1
            total += 4 * windows * (n_out // windows) * (n // windows) * out
            total += 2 * n_out * out * out + 4 * n_out * out * int(out * m["mlp_ratio"])
            n, dim = n_out, out
        outs.append(n)
    return total, outs


def hiera_train_flops_per_clip(m: Mapping, mask_ratio: float) -> float:
    """Model operations of one Hiera MAE training step a clip: 3 x the
    forward of everything but the patch embedding (forward, input and weight
    gradients), 2 x its Conv3d over every token (forward and weight
    gradient: the clip takes none).  The forward: the encoder
    (:func:`encoder_flops`), the fusion heads (``2 n_s d_s D`` for each of
    the first ``q_pool`` stages, ``D`` the last stage's width), the
    decoder's embedding ``2 n_L D Dd``, its blocks over all ``N_dec`` tokens
    (``24 N Dd^2 + 4 N^2 Dd`` a layer) and the head on the masked units'
    tokens."""
    K = kept_units(m, mask_ratio)
    enc, outs = encoder_flops(m, K)
    widths = [int(m["hidden_size"] * m["dim_mul"] ** s) for s in range(len(m["stage_depths"]))]
    D, Dd = widths[-1], m["decoder_hidden_size"]
    fusion = sum(2 * outs[s] * widths[s] * D for s in range(m["q_pool"]))
    pooled = [q ** m["q_pool"] for q in m["q_stride"]]
    grid = (m["num_frames"] // m["tubelet_size"], m["image_size"] // m["patch_size"],
            m["image_size"] // m["patch_size"])
    n_dec = math.prod(g // p for g, p in zip(grid, pooled))
    n_units = math.prod(g // u for g, u in zip(grid, m["mask_unit_size"]))
    masked = n_dec * (n_units - K) // n_units
    ps = m["patch_size"] * m["q_stride"][-1] ** m["q_pool"]
    decoder = (2 * outs[-1] * D * Dd
               + m["decoder_depth"] * (24 * n_dec * Dd * Dd + 4 * n_dec * n_dec * Dd)
               + 2 * masked * Dd * ps * ps * m["in_channels"])
    conv = 2 * math.prod(grid) * m["hidden_size"] * m["in_channels"] * math.prod(
        m["patch_kernel"])
    return float(3 * (enc + fusion + decoder) + 2 * conv)


def flash32_fwd_bound_ms(B: int, N: int, h: int) -> float:
    """Least time of an unmasked attention forward at head width 32."""
    return arith.attention_bound_ms(B, N, h, 32)[0]


def flash32_bwd_bound_ms(B: int, N: int, h: int) -> float:
    """Least time of an unmasked attention backward at head width 32 (five
    products, three outputs)."""
    return arith.bwd_bound_ms(B, N, h, 32, 5, 3)[0]
