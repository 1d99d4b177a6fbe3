"""CLI: one VideoMAE training step under every multi-GPU layout of the port,
on tiny shapes (counterpart of ``__graft_entry__._dryrun_multichip_impl``).

Example::

    python -m bvc_tpu_torch.cli.dryrun_multichip --n 4               # 4 GPUs, NCCL
    python -m bvc_tpu_torch.cli.dryrun_multichip --n 4 --device cpu  # 4 processes, gloo

The command starts ``--n`` ranks itself (a local rendezvous: it hosts the
job's ``TCPStore`` and hands its port to the ranks), each joining the
process group (NCCL on the cards, rank ``r`` on GPU ``r``; gloo on the
CPU).  Every rank then runs one full VideoMAE step (32 px, patch 8, 4
frames, depth 2; on the CPU width 32 and f32 as the JAX dry run, on the
cards width 128 in bf16, so that every head is 64 wide for the flash
kernels) under each layout:

- ``tp``, ``fsdp`` and ``zero1`` (with ``grad_accum=2``) on a ``data`` x
  ``model`` mesh (``model=2`` when ``--n`` is even; ``zero1`` and ``fsdp``
  then keep replicas over ``model``);
- the sequence-parallel step on ``data`` x ``seq`` (``seq`` 4, 2 or 1,
  the clip ``2 * seq`` frames long);
- the GPipe step on ``data`` x ``pipe`` (``pipe`` 2 when ``--n`` is even,
  decoder depth 2).

Rank 0 prints ``dryrun_multichip ok: mesh=... mode=... loss=...`` for each;
a loss that is not finite, or a rank that fails, makes the command exit
non-zero.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from bvc_tpu_torch.cli.common import run_local_ranks

TINY = dict(image_size=32, patch_size=8, num_frames=4, tubelet_size=2, hidden_size=32,
            depth=2, num_heads=4, decoder_hidden_size=16, decoder_depth=1,
            decoder_num_heads=2, dtype="float32")
# on the cards: bf16 and head width 64, so that the seq ring's hops run the
# flash kernels (the other layouts' sequences, at most 32 tokens, are below
# FLASH_MIN_TOKENS and take plain attention either way)
TINY_CARD = {**TINY, "hidden_size": 128, "num_heads": 2, "decoder_hidden_size": 64,
             "decoder_num_heads": 1, "dtype": "bfloat16"}


def build_parser():
    p = argparse.ArgumentParser(description="One tiny VideoMAE step under every layout")
    p.add_argument("--n", type=int, default=1, help="ranks (GPUs, or CPU processes)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds the ranks may take in all")
    return p


def layouts(n: int) -> list[tuple[dict[str, int], str, int, dict]]:
    """``(mesh, mode, grad_accum, model fields)`` of each layout over ``n``
    ranks."""
    model = 2 if n % 2 == 0 else 1
    seq = 4 if n % 4 == 0 else 2 if n % 2 == 0 else 1
    pipe = 2 if n % 2 == 0 else 1
    grid = {"data": n // model, "model": model}
    return [(grid, "tp", 1, {}), (grid, "fsdp", 1, {}), (grid, "zero1", 2, {}),
            ({"data": n // seq, "seq": seq}, "seq", 1, {"num_frames": 2 * seq}),
            ({"data": n // pipe, "pipe": pipe}, "pipe", 1, {"decoder_depth": 2})]


def run_layouts(device: str) -> list[str]:
    """One step under each layout on this rank; the report lines."""
    from bvc_tpu_torch.models.videomae import VideoMAEPretrain
    from bvc_tpu_torch.parallel.mesh import make_mesh, rank, world_size
    from bvc_tpu_torch.parallel.pipeline import make_pipe_videomae_train_step
    from bvc_tpu_torch.parallel.seqpar import make_seq_videomae_train_step
    from bvc_tpu_torch.training.state import TrainState
    from bvc_tpu_torch.training.steps import make_videomae_train_step
    from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig

    lines = []
    for shape, mode, accum, fields in layouts(world_size()):
        mesh = make_mesh(shape)
        cfg = ModelConfig(**{**(TINY if device == "cpu" else TINY_CARD), **fields})
        mask = MaskConfig(sampler="tube", mask_ratio=0.75)
        if mode == "seq":
            step = make_seq_videomae_train_step(cfg, mask, mesh=mesh)
            sharding = "replicated"
        elif mode == "pipe":
            step = make_pipe_videomae_train_step(cfg, mask, num_microbatches=2, mesh=mesh)
            sharding = "replicated"
        else:
            step = make_videomae_train_step(cfg, mask, grad_accum=accum)
            sharding = mode
        state = TrainState.create(VideoMAEPretrain(cfg), OptimConfig(lr=0.01), device=device,
                                  param_sharding=sharding, mesh=mesh)
        frames = getattr(step, "time_slice", slice(None))
        rng = np.random.default_rng(mesh.coord("data"))
        clips = rng.integers(0, 255, (2 * accum, cfg.num_frames, 32, 32, 3), dtype=np.uint8)
        video = torch.from_numpy(clips)[:, frames]
        loss = step(state, video)["loss"].item()
        if not math.isfinite(loss):
            raise FloatingPointError(f"{mode} on {shape}: loss {loss}")
        extra = f" grad_accum={accum}" if accum > 1 else ""
        lines.append(f"dryrun_multichip ok: mesh={mesh.shape} mode={mode}{extra} "
                     f"loss={loss:.4f}")
        if rank() == 0:
            print(lines[-1], flush=True)
    return lines


def main(argv=None) -> list[str]:
    """Start ``--n`` ranks and run every layout on them; rank 0's report
    lines (raises when a rank fails).  Run as a rank (the rendezvous
    variables set), join the group and run the layouts."""
    args = build_parser().parse_args(argv)
    from bvc_tpu_torch.parallel.mesh import distributed_init

    if "RANK" in os.environ:
        distributed_init(device=args.device)
        try:
            return run_layouts(args.device)
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
    if args.device == "cuda" and torch.cuda.device_count() < args.n:
        raise RuntimeError(f"--n {args.n} needs {args.n} GPUs, this host has "
                           f"{torch.cuda.device_count()}; pass --device cpu to run on the CPU")
    logs = run_local_ranks("bvc_tpu_torch.cli.dryrun_multichip",
                           ["--n", str(args.n), "--device", args.device], args.n, args.timeout)
    lines = [line for line in logs[0].splitlines() if line.startswith("dryrun_multichip ok")]
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
