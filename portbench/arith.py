"""The benchmark's frozen arithmetic: published peaks, the model operations
of a step or an embed call, the least time of an attention call, and the
union of device intervals.

These are copies, kept here so that a later change to the program cannot
move the yardstick.  The originals are ``chip_smoke.py``'s
``train_flops_per_clip``, ``embed_flops_per_clip``,
``jepa_train_flops_per_clip``, ``attention_bound_ms``, ``bwd_bound_ms``,
``gemm_bound_ms`` and peaks, and ``bvc_tpu_torch/utils/profiling.py``'s
``_union_us`` / ``busy_us``.  One change: the JEPA count takes the tokens a
batch keeps (``enc_idx`` / ``pred_idx >= 0``), not the collator's caps,
whose padding the step computes but which does no work a user wants.

A configuration is the ``model`` mapping of a ``configs/<name>.json`` file
(plain numbers, the names of the program's ``ModelConfig`` fields).
"""

from __future__ import annotations

from typing import Iterable, Mapping

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def seq_len(m: Mapping) -> int:
    """Tokens of a clip: (frames / tubelet) x (image / patch)^2."""
    return (m["num_frames"] // m["tubelet_size"]) * (m["image_size"] // m["patch_size"]) ** 2


def patch_dim(m: Mapping) -> int:
    return m["in_channels"] * m["tubelet_size"] * m["patch_size"] ** 2


def num_visible(m: Mapping, mask_ratio: float) -> int:
    """Visible tokens of a tube mask: the unmasked spatial patches, in
    every temporal sheet."""
    n_space = (m["image_size"] // m["patch_size"]) ** 2
    return seq_len(m) - int(mask_ratio * n_space) * (m["num_frames"] // m["tubelet_size"])


def train_flops_per_clip(m: Mapping, visible: int) -> float:
    """Model operations of one VideoMAE pretraining step per clip: 3 x the
    forward.  The forward is the encoder at V visible tokens, 24*V*D^2 +
    4*V^2*D per layer, the patch embedding at V, ``enc_to_dec`` 2*V*D*Dd,
    the decoder at all N tokens, 24*N*Dd^2 + 4*N^2*Dd per layer, and the
    head on the N - V masked tokens."""
    V, N, D, Dd = visible, seq_len(m), m["hidden_size"], m["decoder_hidden_size"]
    P = patch_dim(m)
    fwd = (m["depth"] * (24 * V * D * D + 4 * V * V * D) + 2 * V * P * D + 2 * V * D * Dd
           + m["decoder_depth"] * (24 * N * Dd * Dd + 4 * N * N * Dd) + 2 * (N - V) * Dd * P)
    return 3.0 * fwd


def embed_flops_per_clip(m: Mapping) -> float:
    """Model operations of one VideoMAE embed call per clip: per layer
    24*N*D^2 + 4*N^2*D, plus the patch embedding 2*N*P*D."""
    N, D = seq_len(m), m["hidden_size"]
    return m["depth"] * (24 * N * D * D + 4 * N * N * D) + 2 * N * patch_dim(m) * D


def jepa_train_flops_per_clip(m: Mapping, enc_tokens: int, pred_tokens: int,
                              npred: int) -> float:
    """Model operations of one JEPA pretraining step per clip over the
    tokens a batch keeps: the target encoder's forward at all N tokens plus
    its patch embedding; 3 x the context encoder's forward at the Ke kept
    context tokens (its patch embedding runs at all N); 3 x the predictor's
    forward: the embedding 2*Ke*D*Dp, then for each of ``npred`` masks its
    blocks at L = Ke + Kp (Kp kept prediction tokens), 24*L*Dp^2 +
    4*L^2*Dp per layer, and the projection 2*Kp*Dp*D.  With the collator's
    caps for Ke and Kp it is ``chip_smoke.jepa_train_flops_per_clip``."""
    N, D, Dp = seq_len(m), m["hidden_size"], m["pred_emb_dim"]
    Ke, Kp = enc_tokens, pred_tokens
    L = Ke + Kp
    patch = 2 * N * patch_dim(m) * D
    target = m["depth"] * (24 * N * D * D + 4 * N * N * D) + patch
    context = m["depth"] * (24 * Ke * D * D + 4 * Ke * Ke * D) + patch
    predictor = 2 * Ke * D * Dp + npred * (
        m["pred_depth"] * (24 * L * Dp * Dp + 4 * L * L * Dp) + 2 * Kp * Dp * D)
    return float(target + 3 * (context + predictor))


def attention_bound_ms(B: int, N: int, h: int, d: int, bias: bool = False,
                       keys: int | None = None) -> tuple[float, str]:
    """Least time of an attention forward on the card: 4*h*N*K*d
    tensor-core operations at the bf16 peak against q/o (bf16) for every
    token, k/v (bf16) for the K keys needed, LSE (f32) and, with a key bias,
    the [B, N] f32 bias bytes at the HBM rate; the larger bounds.  K =
    ``keys``, the attendable keys summed over the batch, else B*N."""
    keys = B * N if keys is None else keys
    ops_ms = 4 * h * N * keys * d / PEAK_BF16_FLOPS * 1e3
    nbytes = 2 * (B * N + keys) * h * d * 2 + B * h * N * 4 + (B * N * 4 if bias else 0)
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def bwd_bound_ms(B: int, N: int, h: int, d: int, products: int = 5, outputs: int = 3,
                 bias: bool = False, keys: int | None = None) -> tuple[float, str]:
    """Least time of an attention backward on the card: ``products`` N x K
    x d tensor-core products (5 for the whole backward), 2*h*N*K*d
    operations each, against reading qs and dO (bf16) for every token, k
    and v for the K keys needed, L and D (f32), the bias once, and writing
    ``outputs`` bf16 tensors (dQ, dK, dV); the larger bounds."""
    keys = B * N if keys is None else keys
    ops_ms = 2 * products * h * N * keys * d / PEAK_BF16_FLOPS * 1e3
    nbytes = ((2 + outputs) * B * N + 2 * keys) * h * d * 2 + 2 * B * h * N * 4 + (
        B * N * 4 if bias else 0)
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def gemm_bound_ms(M: int, N: int, K: int, in_bytes: int, out_bytes: int, peak: float,
                  vector_bytes: int = 0) -> tuple[float, str]:
    """Least time of ``C [M, N] = A [M, K] B [N, K]^T``: 2MKN operations at
    ``peak`` against reading A and B once, writing C once and
    ``vector_bytes`` of scales and bias; the larger bounds."""
    ops_ms = 2 * M * N * K / peak * 1e3
    nbytes = (M * K + N * K) * in_bytes + M * N * out_bytes + vector_bytes
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def union_us(spans: Iterable[tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals: overlapping
    streams count once."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def merged(spans: Iterable[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def uncovered_us(spans: Iterable[tuple[float, float]],
                 cover: Iterable[tuple[float, float]]) -> float:
    """Length of the union of ``spans`` that no interval of ``cover``
    overlaps."""
    a, b = merged(spans), merged(cover)
    total, j = 0.0, 0
    for lo, hi in a:
        covered = 0.0
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            covered += min(hi, b[k][1]) - max(lo, b[k][0])
            k += 1
        total += (hi - lo) - covered
    return total
