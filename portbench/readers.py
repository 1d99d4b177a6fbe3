"""Arithmetic shared by the per-layer metrics' readers
(``portbench/metrics/<name>.py``): the attention operators' roofline share
over a traced window, the operations of a step, the window's host spans.

An attention call's keys: every token's where the call has no key bias;
with one (V-JEPA), the tokens each batch keeps, which the step reports in
its metrics (``mask_a``: kept context tokens, ``mask_b``: kept prediction
tokens, the same in every row): a call over the context encoder's cap keeps
``mask_a`` keys a row, one over the predictor's sequence ``mask_a +
mask_b``.  A masked call is matched to its step by order: each step makes
as many calls of a shape.
"""

from __future__ import annotations

import statistics

from portbench import arith
from portbench.reference import masks

FLASH_FWD = "bvc_tpu_torch::flash_fwd"
FLASH_BWD = "bvc_tpu_torch::flash_bwd"


def _kept_per_row(view, n: int, step: int) -> int:
    out = view.window["op_metrics_out"][step]
    grid = (view.model["num_frames"] // view.model["tubelet_size"],
            view.model["image_size"] // view.model["patch_size"],
            view.model["image_size"] // view.model["patch_size"])
    m = view.config["mask"]
    enc_cap = masks._cap(grid[1], grid[2], tuple(m["enc_mask_scale"]), (1.0, 1.0))
    a, b = int(out["mask_a"]), int(out["mask_b"])
    return a if n == enc_cap else a + b


def attention_roofline(view, op: str) -> float | None:
    """Percent: the least time of the traced calls of ``op`` (frozen
    bounds, shapes from the profile of the host's operators) over the
    device time of the kernels launched under them."""
    trace = view.window.get("op_trace")
    if trace is None:
        return None
    calls = trace.op_calls(op)
    bias_at = 3 if op == FLASH_FWD else 6
    steps = trace.steps
    seen: dict[tuple, int] = {}
    per_shape: dict[tuple, int] = {}
    for shapes, _ in calls:
        key = tuple(shapes[0])
        per_shape[key] = per_shape.get(key, 0) + 1
    bound_ms = device_us = 0.0
    for shapes, dev_us in calls:
        B, N, h, d = shapes[0]
        bias = len(shapes) > bias_at and bool(shapes[bias_at])
        keys = None
        if bias:
            key = tuple(shapes[0])
            k = seen.get(key, 0)
            seen[key] = k + 1
            step = min(k * steps // per_shape[key], steps - 1)
            keys = B * _kept_per_row(view, N, step)
        if op == FLASH_FWD:
            bound_ms += arith.attention_bound_ms(B, N, h, d, bias, keys)[0]
        else:
            bound_ms += arith.bwd_bound_ms(B, N, h, d, 5, 3, bias, keys)[0]
        device_us += dev_us
    if not calls or device_us <= 0:
        return None
    return 100.0 * bound_ms * 1e3 / device_us


def step_flops_per_clip(view) -> float:
    """Mean model operations a clip over the window's steps."""
    m, family = view.model, view.config["family"]
    if family == "videomae":
        return arith.train_flops_per_clip(m, arith.num_visible(m, view.config["mask"]["mask_ratio"]))
    outs = view.window["metrics_out"]
    npred = view.config["mask"]["num_pred_masks"]
    return statistics.fmean(arith.jepa_train_flops_per_clip(m, int(o["mask_a"]),
                                                            int(o["mask_b"]), npred)
                            for o in outs)


def clips_per_s_per_card(view) -> float:
    return view.window["clips"] / view.window["window_s"] / view.world


def call_ms(view) -> float | None:
    calls = view.window["calls"]
    return 1e3 * statistics.fmean(b - a for a, b in calls) if calls else None


def gap_ms(view) -> float | None:
    calls = view.window["calls"]
    gaps = [c[0] - p[1] for p, c in zip(calls, calls[1:])]
    return 1e3 * statistics.fmean(gaps) if gaps else None
