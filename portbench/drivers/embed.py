"""Window driver of embedding extraction: the function that
``untrained_embed_fn`` returns (the one ``make_embed_fn`` returns after a
checkpoint's load), called back to back on numpy uint8 batches drawn in
turn from a pool made from the seed, numpy f32 embeddings out.

The program builds its encoder, then takes the benchmark's weights
(``portbench/weights.py``).  ``warmup_calls`` calls warm up every shape,
``calibration_calls`` timed calls choose the window's call count, and the
window runs that many calls between two host clock readings (each call
returns host arrays, so it has waited for the device).  Every embedding the
window returns is kept for the comparison.  A traced run runs the same
window, then ``trace_steps`` calls under a profile of the device alone and
``trace_steps`` under one of the host's operators too
(:mod:`portbench.trace`).
"""

from __future__ import annotations

import gc
import importlib
import time

import numpy as np
import torch

from portbench import weights as bench_weights
from portbench.trace import Spans, TraceView, start_device_trace, start_op_trace


def make_pool(traffic: dict, model: dict, seed: int, device) -> list[np.ndarray]:
    """``pool`` batches of uint8 clips ``[batch, frames, S, S, 3]``, drawn
    on the device from the seed and brought to the host."""
    shape = (traffic["batch"], model["num_frames"], model["image_size"], model["image_size"], 3)
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen, device=device)
            .cpu().numpy() for _ in range(traffic["pool"])]


def model_config(ctx):
    """The program's ``ModelConfig`` with every field the configuration
    file states."""
    from portbench.drivers.train import _apply

    cfg_mod = importlib.import_module(ctx.traffic["program"]["config"])
    cfg = cfg_mod.ModelConfig()
    _apply(cfg, ctx.config["model"])
    return cfg


def run(ctx) -> dict:
    t = ctx.traffic
    extract = importlib.import_module(t["program"]["extract"])
    pool = make_pool(t, ctx.config["model"], ctx.seed, ctx.device)
    ctx.pool = pool
    ctx.mark("inputs")
    fn = extract.untrained_embed_fn(ctx.config["family"], model_config(ctx), seed=0,
                                    device=ctx.device)
    ctx.shapes = bench_weights.shapes_of(fn.model)
    ctx.mark("program model")
    fn.model.load_state_dict(bench_weights.make_weights(ctx.shapes, ctx.seed, ctx.device))
    ctx.mark("weights")
    call = fn if ctx.fault is None else ctx.fault.wrap_embed(fn)
    for i in range(t["warmup_calls"]):
        call(pool[i % len(pool)])
    t0 = time.perf_counter()
    for i in range(t["calibration_calls"]):
        call(pool[i % len(pool)])
    per_call = (time.perf_counter() - t0) / t["calibration_calls"]
    n = max(1, round(ctx.seconds / per_call))
    ctx.mark("warm")
    dev = ctx.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    outputs, calls = [], []
    open_epoch, t_open = time.time(), time.perf_counter()
    for i in range(n):
        a = time.perf_counter()
        outputs.append((i % len(pool), call(pool[i % len(pool)])))
        calls.append((a, time.perf_counter()))
    t_close = time.perf_counter()
    rec = {"window_s": t_close - t_open, "steps": n, "clips": n * t["batch"],
           "open_epoch": open_epoch,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
           "calls": calls, "outputs": outputs}
    if ctx.trace:
        for phase in ("device", "op"):
            host = Spans(traced=phase == "op")
            if phase == "device" and dev.type == "cuda":
                prof, marker_s = start_device_trace(dev)
            else:
                prof, marker_s = start_op_trace(dev), time.perf_counter()
            for i in range(t["trace_steps"]):
                with host.span("call"):
                    outputs.append((i % len(pool), call(pool[i % len(pool)])))
            wall = time.perf_counter() - marker_s
            prof.__exit__(None, None, None)
            if phase == "device" and dev.type == "cuda":
                rec["trace"] = TraceView(prof, wall, t["trace_steps"], host.items, marker_s)
            else:
                rec["op_trace" if phase == "op" else "trace"] = TraceView(prof, wall,
                                                                         t["trace_steps"])
    del fn, call
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec
