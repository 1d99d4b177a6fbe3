"""The numbers that decide ``correct``, each held to its limit.

Training (readings of :func:`portbench.reference.train.follow` and the
same readings of the program):

- ``loss_gap``: the largest ``|L_prog - L_ref| / |L_ref|`` over the steps;
- ``grad1_gap``: the first step's gradient, by the worst leaf: the gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``delta3_gap``: the same for each leaf's change after the steps;
- ``target3_gap``: the same for the EMA target's change, where there is one.

Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of the leaf numbers: they move by round-off alone.

Extraction: ``embed_cos_gap``, the largest cosine distance ``1 - cos(e_prog,
e_ref)`` over the rows compared.
"""

from __future__ import annotations

import statistics

import numpy as np

COUNTED_SHARE = 1e-3  # of the median leaf's reference gradient norm


def counted_leaves(ref_g1: dict[str, float]) -> list[str]:
    med = statistics.median(ref_g1.values())
    return [k for k, v in ref_g1.items() if v >= COUNTED_SHARE * med]


def leaf_gap(prog: dict[str, float], ref: dict[str, float], leaves: list[str]) -> float:
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves)


def training_numbers(prog: dict, ref: dict) -> dict[str, float]:
    leaves = counted_leaves(ref["g1"])
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])),
           "grad1_gap": leaf_gap(prog["g1"], ref["g1"], leaves),
           "delta3_gap": leaf_gap(prog["d3"], ref["d3"], leaves)}
    if "t3" in ref:
        kept = [k for k in ref["t3"] if "encoder." + k in leaves]
        out["target3_gap"] = leaf_gap(prog["t3"], ref["t3"], kept)
    return out


def embed_cos_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """Largest cosine distance of a row of ``prog`` from its row of ``ref``
    (both ``[rows, D]``)."""
    p, r = prog.astype(np.float64), ref.astype(np.float64)
    cos = (p * r).sum(1) / (np.linalg.norm(p, axis=1) * np.linalg.norm(r, axis=1))
    return float((1.0 - cos).max())


def judged(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, list]:
    """``(correct, [[name, number, limit], ...])``: every number at or under
    its limit; a number that is not finite fails."""
    rows = [[k, float(v), float(limits[k])] for k, v in numbers.items()]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return bool(ok), rows
