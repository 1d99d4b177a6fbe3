#!/usr/bin/env python3
"""Drive the PyTorch port (``bvc_tpu_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py            # build, check, time; one card
    python3 chip_smoke.py --profile [FILE]  # also a torch.profiler breakdown of one
                                            # embed call, written to FILE if given

1. Build every CUDA kernel of the port from ``bvc_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and print the card, its power
   limit, the versions and the build time.
2. Kernel against plain: the flash forward kernel against its plain PyTorch
   version on the card, at the extraction shape ``[8, 1568, 12, 64]``, an odd
   N and the decoder shape ``[8, 1568, 6, 64]``; O within 2e-2 (bf16 output,
   accumulation in another order), LSE within 1e-3 (f32).  Times of the
   kernel, the plain version and ``F.scaled_dot_product_attention`` (a
   yardstick only: the port never calls it), and of the kernel against the
   plain attention path at N in {160, 392, 784, 1568} for the routing
   threshold.
3. The main path at full width: VideoMAE-B extraction (224 px, 16 frames,
   bf16) through ``untrained_embed_fn``; the launch count of the kernel in
   one embed call must be 12, and the embeddings must agree with the plain
   attention path on the same weights (cosine >= 0.999 per row).  Then
   clips/s, frames/s and MFU at the largest batch in {64, 32, 16} that fits.
4. The entry point: ``extract_embeddings`` over a small synthetic dataset,
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
COSINE_MIN = 0.999


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
    check(FLASH_MIN_TOKENS <= 1568, "FLASH_MIN_TOKENS must route the 1568-token path")
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


def profile_embed(model, x, out_file: str) -> None:
    """torch.profiler breakdown of one embed call: device time by kernel,
    and the device's idle share of the call's wall time; the table is also
    written to ``out_file`` unless it is empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model.embed(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.embed(x)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # device rows only: an operator's row repeats the time of its kernels
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    table = events.table(sort_by="self_device_time_total", row_limit=30)
    print(table, flush=True)
    print(f"profile: device busy {busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms "
          f"wall, idle share {1 - busy_us / wall_us:.3f}", flush=True)

    # The table cannot tell which elementwise kernels belong to which op:
    # time the plain-PyTorch GELU and LayerNorm alone at the block's shapes.
    from bvc_tpu_torch.models.vit import layer_norm
    from bvc_tpu_torch.ops.gelu import gelu

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
    if out_file:
        Path(out_file).parent.mkdir(parents=True, exist_ok=True)
        Path(out_file).write_text(table)


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
                        help="print a torch.profiler breakdown of one embed call "
                             "(and write it to FILE if given)")
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
    kernels = ["flash_fwd"]
    _build.build_all(kernels)
    print(f"built {kernels} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in kernels:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    flash = phase_kernel()
    launches = phase_main_path(smi, args.profile)
    phase_entry_point()

    record = {"name": "flash_fwd", "route": "cuda",
              "source": "bvc_tpu_torch/csrc/flash_fwd.cu",
              "replaces": "bvc_tpu/ops/flash_attention.py:109", "launches": launches,
              **flash}
    check(all(math.isfinite(record[k]) for k in ("max_abs_err", "ms", "plain_ms",
                                                  "bound_ms")), "non-finite timing")
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
