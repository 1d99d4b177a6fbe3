#!/usr/bin/env python3
"""Drive the PyTorch port (``bvc_tpu_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py            # build, check, time; one card
    python3 chip_smoke.py --profile [FILE]  # also torch.profiler breakdowns of one
                                            # embed call and one training step,
                                            # written to FILE and profile_train.txt

1. Build every CUDA kernel of the port from ``bvc_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and print the card, its power
   limit, the versions, the build time and each kernel's registers and
   spills.
2. Forward kernel against plain: the flash forward kernel against its plain
   PyTorch version on the card, at the extraction shape ``[8, 1568, 12, 64]``,
   the encoder's shape in training ``[8, 160, 12, 64]``, an odd N and the
   decoder shape ``[8, 1568, 6, 64]``; O within 2e-2 (bf16
   output, accumulation in another order), LSE within 1e-3 (f32).  Times of
   the kernel, the plain version and ``F.scaled_dot_product_attention`` (a
   yardstick only: the port never calls it), and of the kernel against the
   plain attention path at N in {160, 392, 784, 1568}, forward alone and
   forward plus backward, for the routing threshold.
3. Backward kernels against plain: dQ, dK and dV of the two kernels against
   the plain version at ``[8, 1568, 6, 64]`` (decoder), ``[8, 160, 12, 64]``
   (encoder in training) and ``[8, 197, 12, 64]`` (odd N), each within
   2e-2 x max|ref| (bf16 outputs, sums in another order) and within 1e-3 in
   |err|/|ref|; each kernel's time,
   TFLOP/s and bound, the plain version's time and SDPA's backward as the
   yardstick.
4. Extraction at full width: VideoMAE-B (224 px, 16 frames, bf16) through
   ``untrained_embed_fn``; 12 launches of the forward kernel in one embed
   call, embeddings within cosine 0.999 per row of the plain attention path
   on the same weights; then clips/s, frames/s and MFU at the largest batch
   in {64, 32, 16} that fits.
5. Training at full width, the slice's main path: VideoMAE-B pretraining
   steps (tube mask 0.9, 160 visible tokens, SGD-Nesterov) through
   ``VideoMAEPretrain``, ``TrainState.create`` and
   ``make_videomae_train_step``.  At B=8 one step launches each of the three
   kernels 16 times, and agrees with a step through the plain attention path
   from the same weights, batch and mask (loss within 1e-4 relative,
   gradient cosine >= 0.99 for every top-level group and >= 0.9995 for
   every parameter tensor).  Then clips/s, MFU
   and peak memory at the largest batch in {48, 32, 16} that fits.
6. The entry point: ``extract_embeddings`` over a small synthetic dataset,
   then ``save_results``; row count and width 768.

Prints one JSON ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Exits non-zero, without that last line,
when there is no CUDA device, when run outside a checkout, or when any phase
fails.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
O_TOL = 2e-2
LSE_TOL = 1e-3
BWD_TOL = 2e-2  # of max|ref|: bf16 outputs, sums in another order
BWD_REL_TOL = 1e-3  # |err|/|ref| of dQ, dK and dV (read: 0.8-1.4e-4)
COSINE_MIN = 0.999
# flash vs plain attention in one training step, bf16 activations
TRAIN_LOSS_RTOL = 1e-4  # read: 8.5e-7
GRAD_COSINE_MIN = 0.99  # per top-level group
TENSOR_COSINE_MIN = 0.9995  # per parameter tensor


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(B: int, N: int, h: int, d: int) -> tuple[float, str]:
    """Least time of the forward on the card: 4*B*h*N^2*d tensor-core
    operations at the bf16 peak against q/k/v/o (bf16) and LSE (f32) bytes
    at the HBM rate; the larger one bounds."""
    ops_ms = 4 * B * h * N * N * d / PEAK_BF16_FLOPS * 1e3
    bytes_ms = (4 * B * N * h * d * 2 + B * h * N * 4) / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def bwd_bound_ms(B: int, N: int, h: int, d: int, products: int) -> tuple[float, str]:
    """Least time of one backward kernel on the card: ``products`` N x N x d
    tensor-core products (3 for dQ, 4 for dK/dV), 2*B*h*N^2*d operations
    each, at the bf16 peak, against reading qs, k, v, dO (bf16), L and D
    (f32) once and writing dQ, or dK and dV (bf16), at the HBM rate; the
    larger one bounds."""
    ops_ms = 2 * products * B * h * N * N * d / PEAK_BF16_FLOPS * 1e3
    elems = B * N * h * d
    outputs = 1 if products == 3 else 2
    nbytes = (4 + outputs) * elems * 2 + 2 * B * h * N * 4
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def train_flops_per_clip(cfg, num_visible: int) -> float:
    """Model operations of one VideoMAE pretraining step per clip: 3 x the
    forward (the backward takes twice the forward's products).  The forward
    is the encoder at V visible tokens, 24*V*D^2 + 4*V^2*D per layer, the
    patch embedding at V, 2*V*(C*ts*p*p)*D, ``enc_to_dec`` 2*V*D*Dd, the
    decoder at all N tokens, 24*N*Dd^2 + 4*N^2*Dd per layer, and the head
    on the M = N - V masked tokens, 2*M*Dd*(C*ts*p*p)."""
    V, N, D, Dd = num_visible, cfg.seq_len, cfg.hidden_size, cfg.decoder_hidden_size
    patch_dim = cfg.in_channels * cfg.tubelet_size * cfg.patch_size ** 2
    fwd = (cfg.depth * (24 * V * D * D + 4 * V * V * D) + 2 * V * patch_dim * D
           + 2 * V * D * Dd + cfg.decoder_depth * (24 * N * Dd * Dd + 4 * N * N * Dd)
           + 2 * (N - V) * Dd * patch_dim)
    return 3 * fwd


def embed_flops_per_clip(cfg) -> float:
    """Model operations of one VideoMAE embed: per layer 24*N*D^2 for the
    qkv/proj/fc1/fc2 products and 4*N^2*D for attention, plus the patch
    embedding 2*N*(C*ts*p*p)*D."""
    N, D = cfg.seq_len, cfg.hidden_size
    patch_dim = cfg.in_channels * cfg.tubelet_size * cfg.patch_size ** 2
    return cfg.depth * (24 * N * D * D + 4 * N * N * D) + 2 * N * patch_dim * D


def qkv_inputs(B: int, N: int, h: int, d: int, seed: int):
    """Pre-scaled q and strided k/v slices of one fused ``[B, N, 3, h, d]``
    bf16 tensor, as the encoder block hands them to the kernel."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = 2 * torch.randn((B, N, 3, h, d), generator=gen, device="cuda")
    qkv = qkv.to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return q, (q * d ** -0.5).to(q.dtype), k, v


def phase_kernel() -> dict:
    """Flash forward kernel against its plain version; returns its timings
    at the extraction shape."""
    import torch
    import torch.nn.functional as F

    from bvc_tpu_torch.ops.attention import (FLASH_MIN_TOKENS, flash_attention,
                                             multi_head_attention, plain_attention)
    from bvc_tpu_torch.ops.flash_attention import (flash_attention_fwd_ref,
                                                   flash_fwd_cuda)

    result = {}
    for label, (B, N, h, d) in (("extraction", (8, 1568, 12, 64)),
                                ("encoder", (8, 160, 12, 64)),
                                ("odd N", (8, 197, 12, 64)),
                                ("decoder", (8, 1568, 6, 64))):
        _, qs, k, v = qkv_inputs(B, N, h, d, seed=N + h)
        o, lse = flash_fwd_cuda(qs, k, v)
        o_ref, lse_ref = flash_attention_fwd_ref(qs, k, v)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        ok_o = torch.allclose(o.float(), o_ref.float(), atol=O_TOL, rtol=O_TOL)
        ok_lse = torch.allclose(lse, lse_ref, atol=LSE_TOL, rtol=LSE_TOL)
        ms = time_ms(lambda: flash_fwd_cuda(qs, k, v))
        plain_ms = time_ms(lambda: flash_attention_fwd_ref(qs, k, v), iters=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (qs, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0))
        bound, bound_by = attention_bound_ms(B, N, h, d)
        print(f"flash_fwd [{B},{N},{h},{d}] ({label}): max|dO| {err_o:.3e} "
              f"max|dLSE| {err_lse:.3e}; kernel {ms:.4f} ms "
              f"({ms / B * 1e3:.2f} us/clip), plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms "
              f"({bound / B * 1e3:.2f} us/clip, {bound_by}); "
              f"{4 * B * h * N * N * d / ms / 1e9:.1f} TFLOP/s", flush=True)
        check(ok_o, f"flash_fwd O disagrees with the plain version at {label}: {err_o}")
        check(ok_lse, f"flash_fwd LSE disagrees with the plain version at {label}: {err_lse}")
        if label == "extraction":
            result = {"max_abs_err": err_o, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by}

    # What the kernel does not take raises on the card: no plain fallback.
    q, _, k, v = qkv_inputs(2, 64, 2, 64, seed=0)
    mask = torch.ones(2, 64, dtype=torch.bool, device="cuda")
    for what, call in (("f32", lambda: multi_head_attention(q.float(), k.float(), v.float(),
                                                            impl="flash")),
                       ("key mask", lambda: multi_head_attention(q, k, v, impl="flash",
                                                                 key_mask=mask)),
                       ("head width 32", lambda: flash_fwd_cuda(q[..., :32], k[..., :32],
                                                                v[..., :32]))):
        try:
            call()
        except (ValueError, NotImplementedError):
            continue
        fail(f"impl='flash' with {what} on CUDA ran instead of raising")

    # Routing: kernel (public flash_attention, scale folding included)
    # against the plain attention path that 'auto' picks below the threshold.
    faster = {}
    for N in (160, 392, 784, 1568):
        q, _, k, v = qkv_inputs(8, N, 12, 64, seed=N)
        k_ms = time_ms(lambda: flash_attention(q, k, v))
        p_ms = time_ms(lambda: plain_attention(q, k, v, 0.125), iters=5)
        faster[N] = k_ms < p_ms
        print(f"routing [8,{N},12,64]: flash {k_ms:.4f} ms, plain {p_ms:.4f} ms",
              flush=True)
    crossover = min((n for n in faster if all(faster[m] for m in faster if m >= n)),
                    default=None)
    print(f"routing: flash wins from N={crossover} of those measured; "
          f"FLASH_MIN_TOKENS = {FLASH_MIN_TOKENS}", flush=True)

    # The same, forward plus backward, as a training step runs them.
    for N in (160, 392, 784, 1568):
        q, _, k, v = qkv_inputs(8, N, 12, 64, seed=N)
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        do = torch.randn(q.shape, device="cuda").to(torch.bfloat16)

        def fwd_bwd(impl):
            out = multi_head_attention(q, k, v, impl=impl)
            return torch.autograd.grad(out, (q, k, v), do)

        k_ms = time_ms(lambda: fwd_bwd("flash"))
        p_ms = time_ms(lambda: fwd_bwd("xla"), iters=5)
        print(f"routing fwd+bwd [8,{N},12,64]: flash {k_ms:.4f} ms, plain {p_ms:.4f} ms",
              flush=True)
    check(FLASH_MIN_TOKENS <= 1568, "FLASH_MIN_TOKENS must route the 1568-token path")
    return result


def phase_bwd_kernel() -> dict:
    """The dQ and dK/dV kernels against their plain version at the decoder,
    encoder-in-training and odd-N shapes; returns their records at the
    decoder shape."""
    import torch
    import torch.nn.functional as F

    from bvc_tpu_torch.ops.flash_attention import (bwd_operands, flash_attention_bwd_ref,
                                                   flash_bwd_cuda, flash_fwd_cuda,
                                                   launch_dkv, launch_dq)

    result = {}
    for label, (B, N, h, d) in (("decoder", (8, 1568, 6, 64)),
                                ("encoder", (8, 160, 12, 64)),
                                ("odd N", (8, 197, 12, 64))):
        _, qs, k, v = qkv_inputs(B, N, h, d, seed=2 * N + h)
        gen = torch.Generator(device="cuda").manual_seed(N)
        do = torch.randn((B, N, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        o, lse = flash_fwd_cuda(qs, k, v)
        grads = flash_bwd_cuda(qs, k, v, o, lse, do)
        refs = flash_attention_bwd_ref(qs, k, v, o, lse, do)
        torch.cuda.synchronize()
        errs = {}
        for name, x, ref in zip(("dq", "dk", "dv"), grads, refs):
            diff = (x.float() - ref.float())
            err, scale = diff.abs().max().item(), ref.float().abs().max().item()
            rel = (diff.norm() / ref.float().norm()).item()
            errs[name] = err
            print(f"flash_bwd [{B},{N},{h},{d}] ({label}) {name}: max abs err {err:.3e} "
                  f"(bound {BWD_TOL * scale:.3e} = {BWD_TOL} x max|ref|), "
                  f"|err|/|ref| {rel:.3e} (bound {BWD_REL_TOL})", flush=True)
            check(err <= BWD_TOL * scale and math.isfinite(err),
                  f"flash_bwd {name} disagrees with the plain version at {label}: {err}")
            check(rel <= BWD_REL_TOL,
                  f"flash_bwd {name} at {label}: |err|/|ref| {rel} > {BWD_REL_TOL}")

        operands = bwd_operands(qs, k, v, o, lse, do)
        dq_ms = time_ms(lambda: launch_dq(*operands))
        dkv_ms = time_ms(lambda: launch_dkv(*operands))
        plain_ms = time_ms(lambda: flash_attention_bwd_ref(qs, k, v, o, lse, do), iters=5)
        # yardstick only (the port never calls it): SDPA's backward, taken
        # as its forward plus backward less its forward alone
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (qs, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)

        sdpa_fb_ms = time_ms(lambda: torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot))
        lib_ms = sdpa_fb_ms - time_ms(sdpa_fwd)
        line = [f"flash_bwd [{B},{N},{h},{d}] ({label}):"]
        for name, ms, products in (("dq", dq_ms, 3), ("dkv", dkv_ms, 4)):
            bound, bound_by = bwd_bound_ms(B, N, h, d, products)
            tflops = 2 * products * B * h * N * N * d / ms / 1e9
            line.append(f"{name} kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s), bound "
                        f"{bound:.4f} ms ({bound_by});")
            if label == "decoder":
                err = errs["dq"] if name == "dq" else max(errs["dk"], errs["dv"])
                result[name] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by}
        line.append(f"plain (both) {plain_ms:.4f} ms; sdpa backward {lib_ms:.4f} ms")
        print(" ".join(line), flush=True)

    # What the kernels do not take raises on the card: no plain fallback.
    q, qs, k, v = qkv_inputs(2, 64, 2, 64, seed=0)
    o, lse = flash_fwd_cuda(qs, k, v)
    for what, call in (("f32", lambda: flash_bwd_cuda(qs.float(), k.float(), v.float(),
                                                      o.float(), lse, o.float())),
                       ("head width 32", lambda: flash_bwd_cuda(
                           qs[..., :32], k[..., :32], v[..., :32], o[..., :32], lse,
                           o[..., :32])),
                       ("lse of another shape", lambda: flash_bwd_cuda(
                           qs, k, v, o, lse[:, :1], o))):
        try:
            call()
        except ValueError:
            continue
        fail(f"flash_bwd_cuda with {what} on CUDA ran instead of raising")
    return result


def phase_main_path(card: str, profile: str | None) -> int:
    """VideoMAE-B extraction on the card; returns the kernel's launches in
    one embed call."""
    import numpy as np
    import torch

    from bvc_tpu_torch.evalbench.extract import untrained_embed_fn
    from bvc_tpu_torch.ops.flash_attention import flash_fwd_cuda
    from bvc_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig()
    fn = untrained_embed_fn("videomae", cfg, seed=0)
    rng = np.random.default_rng(0)
    clips = rng.integers(0, 256, (8, cfg.num_frames, cfg.image_size, cfg.image_size,
                                  cfg.in_channels), dtype=np.uint8)

    flash_fwd_cuda.launches = 0
    emb = fn(clips)
    launches = flash_fwd_cuda.launches
    print(f"main path: one embed call at B=8 launched flash_fwd {launches} times",
          flush=True)
    check(launches == cfg.depth, f"expected {cfg.depth} flash_fwd launches, got {launches}")
    check(emb.shape == (8, cfg.hidden_size) and bool(np.isfinite(emb).all()),
          f"embeddings of shape {emb.shape} or not finite")

    with torch.inference_mode():
        ref = fn.model.embed(torch.from_numpy(clips).cuda(), attn_impl="xla").cpu().numpy()
    cos = (emb * ref).sum(1) / (np.linalg.norm(emb, axis=1) * np.linalg.norm(ref, axis=1))
    print(f"main path: cosine to the plain-attention path min {cos.min():.6f}, "
          f"max|diff| {np.abs(emb - ref).max():.4e}", flush=True)
    check(bool(cos.min() >= COSINE_MIN), f"embed cosine {cos.min()} < {COSINE_MIN}")

    flops = embed_flops_per_clip(cfg)
    for B in (64, 32, 16):
        try:
            batch = rng.integers(0, 256, (B,) + clips.shape[1:], dtype=np.uint8)
            x = torch.from_numpy(batch).cuda()
            with torch.inference_mode():
                dev_ms = time_ms(lambda: fn.model.embed(x), iters=5, warmup=2)
            fn(batch)
            t0 = time.perf_counter()
            for _ in range(3):
                fn(batch)
            host_s = (time.perf_counter() - t0) / 3
        except torch.cuda.OutOfMemoryError:
            print(f"main path: B={B} does not fit", flush=True)
            torch.cuda.empty_cache()
            continue
        clips_s = B / (dev_ms / 1e3)
        print(f"main path [{card}]: B={B} embed {dev_ms:.2f} ms on device -> "
              f"{clips_s:.1f} clips/s, {clips_s * cfg.num_frames:.1f} frames/s, "
              f"MFU {flops * clips_s / PEAK_BF16_FLOPS:.3f} "
              f"({flops / 1e9:.1f} GFLOP/clip); entry point with host copies "
              f"{B / host_s:.1f} clips/s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
        if profile is not None:
            profile_embed(fn.model, x, profile)
        break
    else:
        fail("no batch size in {64, 32, 16} fits")
    return launches


def profile_call(fn, what: str, out_file: str) -> float:
    """torch.profiler breakdown of one call of ``fn`` (after one untimed
    call): device time by kernel, and the device's idle share of the call's
    wall time; the table is also written to ``out_file`` unless it is
    empty.  Returns the device-busy microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # device rows only: an operator's row repeats the time of its kernels
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    table = events.table(sort_by="self_device_time_total", row_limit=30)
    print(table, flush=True)
    print(f"profile ({what}): device busy {busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms "
          f"wall, idle share {1 - busy_us / wall_us:.3f}", flush=True)
    if out_file:
        Path(out_file).parent.mkdir(parents=True, exist_ok=True)
        Path(out_file).write_text(table)
    return busy_us


def profile_embed(model, x, out_file: str) -> None:
    """:func:`profile_call` of one embed call, then the plain-PyTorch GELU
    and LayerNorm timed alone at the block's shapes (the table cannot tell
    which elementwise kernels belong to which op)."""
    import torch

    from bvc_tpu_torch.models.vit import layer_norm
    from bvc_tpu_torch.ops.gelu import gelu

    with torch.inference_mode():
        busy_us = profile_call(lambda: model.embed(x), "one embed call", out_file)
    cfg = model.cfg
    B, N, D = x.shape[0], cfg.seq_len, cfg.hidden_size
    h = torch.randn(B, N, int(D * cfg.mlp_ratio), device=x.device, dtype=torch.bfloat16)
    a = torch.randn(B, N, D, device=x.device, dtype=torch.bfloat16)
    w, b = torch.ones(D, device=x.device), torch.zeros(D, device=x.device)
    with torch.inference_mode():
        per_call = {"gelu_poly": (time_ms(lambda: gelu(h), iters=5), cfg.depth),
                    "layer_norm": (time_ms(lambda: layer_norm(a, w, b), iters=5),
                                   2 * cfg.depth)}
    for name, (ms, calls) in per_call.items():
        print(f"profile: {name} {ms:.3f} ms x {calls} calls = {ms * calls:.1f} ms, "
              f"{ms * calls * 1e3 / busy_us:.3f} of device time", flush=True)


def profile_train(step, state, video, num_visible: int, out_file: str) -> None:
    """:func:`profile_call` of one training step, then the plain-PyTorch
    GELU and LayerNorm, forward plus backward, timed alone at the step's
    shapes (encoder at the visible tokens, decoder at all of them)."""
    import torch

    from bvc_tpu_torch.models.vit import layer_norm
    from bvc_tpu_torch.ops.gelu import gelu

    B = video.shape[0]
    busy_us = profile_call(lambda: step(state, video), f"one training step at B={B}",
                           out_file)
    cfg = state.model.cfg

    def fwd_bwd(fn, *shape_of_x_and_params):
        xs = [torch.randn(s, device=video.device, dtype=dt, requires_grad=True)
              for s, dt in shape_of_x_and_params]
        y = fn(*xs)
        return lambda: torch.autograd.grad(fn(*xs), xs, torch.ones_like(y))

    bf16, f32 = torch.bfloat16, torch.float32
    per_call = {}
    for where, n, d, layers, norms in (
            ("encoder", num_visible, cfg.hidden_size, cfg.depth, 2 * cfg.depth),
            ("decoder", cfg.seq_len, cfg.decoder_hidden_size, cfg.decoder_depth,
             2 * cfg.decoder_depth + 1)):
        hidden = int(d * cfg.mlp_ratio)
        per_call[f"gelu_poly {where}"] = (
            time_ms(fwd_bwd(gelu, ((B, n, hidden), bf16)), iters=5), layers)
        per_call[f"layer_norm {where}"] = (
            time_ms(fwd_bwd(layer_norm, ((B, n, d), bf16), ((d,), f32), ((d,), f32)),
                    iters=5), norms)
    for name, (ms, calls) in per_call.items():
        print(f"profile: {name} forward+backward {ms:.3f} ms x {calls} calls = "
              f"{ms * calls:.1f} ms, {ms * calls * 1e3 / busy_us:.3f} of device time",
              flush=True)


def phase_train(card: str, profile: str | None) -> dict[str, int]:
    """VideoMAE-B pretraining steps on the card through the port's entry
    points (``VideoMAEPretrain``, ``TrainState.create``,
    ``make_videomae_train_step``), as ``bench.py`` configures the JAX
    flagship.  Returns each kernel's launches in one step at B=8."""
    import gc

    import numpy as np
    import torch

    from bvc_tpu_torch.models.videomae import VideoMAEPretrain
    from bvc_tpu_torch.ops.flash_attention import flash_bwd_cuda, flash_fwd_cuda
    from bvc_tpu_torch.training.state import TrainState
    from bvc_tpu_torch.training.steps import make_videomae_train_step
    from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig

    cfg = ModelConfig()
    mask_cfg = MaskConfig(sampler="tube", mask_ratio=0.9)
    optim = OptimConfig(name="sgd", lr=0.1, momentum=0.9)
    num_visible = cfg.num_time_steps * (cfg.tokens_per_frame
                                        - int(mask_cfg.mask_ratio * cfg.tokens_per_frame))
    rng = np.random.default_rng(0)

    def clips(B):
        shape = (B, cfg.num_frames, cfg.image_size, cfg.image_size, cfg.in_channels)
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()

    # B=8: the kernels' launches in one step, and the step against the
    # plain attention path from the same weights, batch and mask (both
    # states draw the mask from generators of one seed).
    video = clips(8)
    state = TrainState.create(VideoMAEPretrain(cfg, seed=0), optim, seed=1)
    step = make_videomae_train_step(cfg, mask_cfg)
    flash_fwd_cuda.launches = flash_bwd_cuda.launches_dq = flash_bwd_cuda.launches_dkv = 0
    metrics = step(state, video)
    torch.cuda.synchronize()
    launches = {"flash_fwd": flash_fwd_cuda.launches,
                "flash_bwd_dq": flash_bwd_cuda.launches_dq,
                "flash_bwd_dkv": flash_bwd_cuda.launches_dkv}
    print(f"train: one step at B=8 launched {launches}", flush=True)
    layers = cfg.depth + cfg.decoder_depth
    check(all(n == layers for n in launches.values()),
          f"expected {layers} launches of each kernel in one step, got {launches}")

    plain = TrainState.create(VideoMAEPretrain(cfg, seed=0), optim, seed=1)
    plain_metrics = make_videomae_train_step(cfg, mask_cfg, attn_impl="xla")(plain, video)
    loss, plain_loss = metrics["loss"].item(), plain_metrics["loss"].item()
    rel = abs(loss - plain_loss) / abs(plain_loss)
    print(f"train: loss {loss:.6f}, plain attention {plain_loss:.6f} (rel {rel:.2e}); "
          f"grad_norm {metrics['grad_norm'].item():.4e} vs "
          f"{plain_metrics['grad_norm'].item():.4e}", flush=True)
    check(math.isfinite(loss) and rel <= TRAIN_LOSS_RTOL,
          f"train loss {loss} vs plain {plain_loss}: rel {rel} > {TRAIN_LOSS_RTOL}")
    groups = ("encoder.patch_embed.", "encoder.blocks.", "enc_to_dec.", "mask_token",
              "decoder.", "decoder_norm.", "decoder_head.")
    flash_grads = {n: p.grad.flatten() for n, p in state.model.named_parameters()}
    plain_grads = {n: p.grad.flatten() for n, p in plain.model.named_parameters()}
    cosine = torch.nn.functional.cosine_similarity
    for group in groups:
        names = [n for n in flash_grads if n.startswith(group)]
        cos = cosine(torch.cat([flash_grads[n] for n in names]),
                     torch.cat([plain_grads[n] for n in names]), dim=0).item()
        print(f"train: gradient cosine to the plain path, {group:<22} {cos:.6f}", flush=True)
        check(cos >= GRAD_COSINE_MIN, f"gradient cosine of {group} {cos} < {GRAD_COSINE_MIN}")
    # each tensor alone, so one wrong layer cannot hide in its group
    per_tensor = sorted((cosine(flash_grads[n], plain_grads[n], dim=0).item(), n)
                        for n in flash_grads)
    print(f"train: gradient cosine per tensor ({len(per_tensor)} tensors), lowest: "
          + ", ".join(f"{n} {c:.6f}" for c, n in per_tensor[:5]), flush=True)
    check(per_tensor[0][0] >= TENSOR_COSINE_MIN,
          f"gradient cosine of {per_tensor[0][1]} {per_tensor[0][0]} < {TENSOR_COSINE_MIN}")
    del state, plain, flash_grads, plain_grads
    gc.collect()
    torch.cuda.empty_cache()

    flops = train_flops_per_clip(cfg, num_visible)
    for B in (48, 32, 16):
        try:
            torch.cuda.reset_peak_memory_stats()
            state = TrainState.create(VideoMAEPretrain(cfg, seed=0), optim, seed=1)
            video = clips(B)
            for _ in range(3):
                step(state, video)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses = [step(state, video)["loss"] for _ in range(10)]
            end.record()
            torch.cuda.synchronize()
            fits = True
        except torch.cuda.OutOfMemoryError:
            fits = False
        if not fits:  # outside the handler, whose traceback holds the step's tensors
            print(f"train: B={B} does not fit", flush=True)
            state = video = None
            gc.collect()
            torch.cuda.empty_cache()
            continue
        ms = start.elapsed_time(end) / 10
        losses = torch.stack(losses).tolist()
        check(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
        clips_s = B / (ms / 1e3)
        print(f"train [{card}]: B={B} step {ms:.2f} ms -> {clips_s:.1f} clips/s, "
              f"MFU {flops * clips_s / PEAK_BF16_FLOPS:.4f} ({flops / 1e9:.1f} GFLOP/clip), "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
              f"losses {losses[0]:.4f} .. {losses[-1]:.4f}", flush=True)
        if profile is not None:
            profile_train(step, state, video, num_visible,
                          str(Path(profile).with_name("profile_train.txt")) if profile else "")
        break
    else:
        fail("no batch size in {48, 32, 16} fits")
    return launches


def phase_entry_point() -> None:
    """extract_embeddings over a synthetic dataset, then save_results."""
    import numpy as np
    import pandas as pd

    from bvc_tpu_torch.evalbench.extract import (extract_embeddings, save_results,
                                                 untrained_embed_fn)
    from bvc_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig()

    class SyntheticClips:
        """11 uint8 clips, one of them unreadable, as a reader reports it."""

        def __len__(self):
            return 11

        def __getitem__(self, i):
            if i == 5:
                return None, f"clip_{i:02d}"
            rng = np.random.default_rng(i)
            shape = (cfg.num_frames, cfg.image_size, cfg.image_size, cfg.in_channels)
            return rng.integers(0, 256, shape, dtype=np.uint8), f"clip_{i:02d}"

    fn = untrained_embed_fn("videomae", cfg, seed=1)
    names, embs = extract_embeddings(fn, SyntheticClips(), batch_size=4, num_workers=2)
    check(len(names) == 10 and embs.shape == (10, cfg.hidden_size),
          f"extract_embeddings gave {len(names)} names and {embs.shape}")
    check(bool(np.isfinite(embs).all()), "extracted embeddings not finite")
    with tempfile.TemporaryDirectory() as d:
        path = save_results(names, embs, "test", "untrained_0", d)
        df = pd.read_csv(path)
        check(Path(path).parent.name == "test", f"test split written to {path}")
        check(df.shape == (10, cfg.hidden_size + 1), f"CSV of shape {df.shape}")
        check(list(df["fnames"]) == sorted(names), "CSV rows not sorted by fname")
    print(f"entry point: extract_embeddings -> save_results wrote {df.shape[0]} rows "
          f"of width {df.shape[1] - 1}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", nargs="?", const="", default=None, metavar="FILE",
                        help="print torch.profiler breakdowns of one embed call and "
                             "one training step (and write them to FILE and to "
                             "profile_train.txt beside it if given)")
    args = parser.parse_args()
    if not (REPO / "bvc_tpu_torch" / "csrc").is_dir():
        fail(f"no bvc_tpu_torch package beside {Path(__file__).name}: run it from "
             "the root of a checkout")
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")

    from bvc_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    kernels = ["flash_fwd", "flash_bwd"]
    _build.build_all(kernels)
    print(f"built {kernels} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in kernels:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    flash = phase_kernel()
    bwd = phase_bwd_kernel()
    embed_launches = phase_main_path(smi, args.profile)
    train_launches = phase_train(smi, args.profile)
    phase_entry_point()

    # launches: per training step (the slice's main path) and per embed call
    records = [
        {"name": "flash_fwd", "route": "cuda", "source": "bvc_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "bvc_tpu/ops/flash_attention.py:109",
         "launches": train_launches["flash_fwd"], "launches_per_embed": embed_launches,
         "at": [8, 1568, 12, 64], **flash},
        {"name": "flash_bwd_dq", "route": "cuda", "source": "bvc_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "bvc_tpu/ops/flash_attention.py:250",
         "launches": train_launches["flash_bwd_dq"], "at": [8, 1568, 6, 64],
         **bwd["dq"]},
        {"name": "flash_bwd_dkv", "route": "cuda", "source": "bvc_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "bvc_tpu/ops/flash_attention.py:278",
         "launches": train_launches["flash_bwd_dkv"], "at": [8, 1568, 6, 64],
         **bwd["dkv"]},
    ]
    check(all(math.isfinite(r[k]) for r in records
              for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms")),
          "non-finite timing")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
