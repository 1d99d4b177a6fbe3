"""Frozen arithmetic of the V-JEPA 2 cell's metrics: the least time of a
RoPE launch and the model operations of a V-JEPA 2 training step.  Kept
beside the benchmark (and not read from the program) so that a change to the
program cannot move the yardstick; ``portbench/arith.py`` holds the peaks.
"""

from __future__ import annotations

from typing import Mapping

from portbench import arith


def rope_bytes(B: int, N: int, h: int, d: int, grid_tokens: int, pairs: int) -> int:
    """Bytes one RoPE launch (either direction) must move: q and k read and
    written in bf16, the int32 positions and the f32 cos and sin tables
    ``[grid_tokens, pairs]`` read once."""
    return 4 * B * N * h * d * 2 + B * N * 4 + 2 * grid_tokens * pairs * 4


def rope_bound_ms(B: int, N: int, h: int, d: int, grid_tokens: int, pairs: int) -> float:
    """Least time of one RoPE launch: its bytes at the HBM rate (it does a
    few f32 operations a byte, far below the card's ridge)."""
    return rope_bytes(B, N, h, d, grid_tokens, pairs) / arith.PEAK_HBM_BYTES * 1e3


def blocks_flops(depth: int, n: int, d: int, f: int) -> int:
    """Operations of ``depth`` pre-LN blocks over ``n`` tokens of width
    ``d`` with an MLP of width ``f``: per layer 8nd^2 (qkv and the
    projection), 4ndf (the MLP) and 4n^2 d (scores and P.V)."""
    return depth * (8 * n * d * d + 4 * n * d * f + 4 * n * n * d)


def vjepa2_train_flops_per_clip(m: Mapping, enc_tokens: int, pred_tokens: int) -> float:
    """Model operations of one V-JEPA 2 training step per clip, each MLP at
    its own width: the target encoder's forward at all N tokens and its
    patch embedding; 3 x the context encoder's forward at the Ke kept
    context tokens (its patch embedding runs at all N); 3 x the predictor's
    forward: the embedding 2 Ke D Dp, its blocks at Ke + Kp tokens, the
    projection 2 Kp Dp D (one prediction mask)."""
    N, D, Dp = arith.seq_len(m), m["hidden_size"], m["pred_emb_dim"]
    F = int(D * m["mlp_ratio"])
    Fp = int(Dp * (m.get("pred_mlp_ratio") or m["mlp_ratio"]))
    Ke, Kp = enc_tokens, pred_tokens
    patch = 2 * N * arith.patch_dim(m) * D
    target = blocks_flops(m["depth"], N, D, F) + patch
    context = blocks_flops(m["depth"], Ke, D, F) + patch
    predictor = (2 * Ke * D * Dp + blocks_flops(m["pred_depth"], Ke + Kp, Dp, Fp)
                 + 2 * Kp * Dp * D)
    return float(target + 3 * (context + predictor))
