"""CLI: the collectives a full-width train step issues under each multi-GPU
layout (counterpart of ``tools/analyze_collectives.py``).

Example::

    python -m bvc_tpu_torch.cli.analyze_collectives --n 8                  # 8 GPUs, NCCL
    python -m bvc_tpu_torch.cli.analyze_collectives --n 8 --backend gloo   # 8 ranks on the cards there are
    python -m bvc_tpu_torch.cli.analyze_collectives --n 2 --device cpu --tiny

The command starts ``--n`` ranks itself (the local rendezvous of
:func:`~bvc_tpu_torch.cli.common.run_local_ranks`): NCCL on the cards, a
card a rank, or gloo with ``--backend gloo`` (ranks sharing the host's
cards, rank ``r`` on card ``r % cards``) or ``--device cpu``.  Every rank
builds the real VideoMAE-B (``--family videomae``: 224 px, 16 frames, the
tube mask at 0.9) or the JEPA CLI's V-JEPA ViT-B (``--family jepa``: 2
frames, the multi-block collator) in bf16 from seed 0, and takes one step's
``comm_report`` (:mod:`bvc_tpu_torch.parallel.analysis`), after one step
(DDP reduces every gradient in one bucket in its first step, then rebuilds
its buckets in the backward's order), under each of the JAX tool's
layouts, at ``--batch`` clips a data rank (zero clips):

- ``dp``: DDP over ``data = n``; ``dp+accum4``: the same with
  ``grad_accum=4``;
- ``fsdp``: FSDP2 over ``data = n``;
- ``tp2xdp{n/2}``: ``tp`` at ``data=n/2,model=2``;
- ``dp{n/4}xseq4`` (VideoMAE): the sequence-parallel step at
  ``data=n/4,seq=4``;
- ``dp{n/2}xpipe2`` (VideoMAE): the GPipe step at ``data=n/2,pipe=2``, 2
  microbatches (JAX's pipe step feeds its analysis too).

At ``--n 8`` these are the JAX tool's ``dp``, ``dp+accum4``, ``fsdp``,
``tp2xdp4`` and ``dp2xseq4``.  A layout the world cannot hold is skipped
with a line that says so.  Rank 0's reports are printed: one JSON line per
layout with the JAX tool's keys, then its markdown table (with a broadcast
column when a layout broadcasts).  The counts are bytes and op counts, not
times.  ``--tiny`` runs the dry run's tiny models instead (tests).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys

import torch

from bvc_tpu_torch.cli.common import run_local_ranks

MODULE = "bvc_tpu_torch.cli.analyze_collectives"
BIG = 1024  # scalar metrics are tiny; gradient buffers are not


def build_parser():
    p = argparse.ArgumentParser(description="Collectives of a train step under each layout")
    p.add_argument("--family", default="videomae", choices=["videomae", "jepa"])
    p.add_argument("--batch", type=int, default=2, help="clips a data rank (per microbatch)")
    p.add_argument("--n", type=int, default=8, help="ranks (GPUs, or CPU processes)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="default: nccl on cuda (a card a rank), gloo on the CPU")
    p.add_argument("--tiny", action="store_true", help="the dry run's tiny models (tests)")
    p.add_argument("--timeout", type=float, default=1200.0,
                   help="seconds the ranks may take in all")
    return p


def layouts(n: int, family: str) -> list[tuple[str, dict[str, int] | None, str, int]]:
    """``(name, mesh, mode, grad_accum)`` of each layout over ``n`` ranks; the
    mesh None where ``n`` cannot hold it."""
    out = [("dp", {"data": n}, "replicated", 1), ("dp+accum4", {"data": n}, "replicated", 4),
           ("fsdp", {"data": n}, "fsdp", 1),
           (f"tp2xdp{n // 2}", {"data": n // 2, "model": 2} if n % 2 == 0 else None, "tp", 1)]
    if family == "videomae":
        out += [(f"dp{n // 4}xseq4", {"data": n // 4, "seq": 4} if n % 4 == 0 else None,
                 "seq", 1),
                (f"dp{n // 2}xpipe2", {"data": n // 2, "pipe": 2} if n % 2 == 0 else None,
                 "pipe", 1)]
    return out


def _configs(family: str, tiny: bool, device: str):
    """``(model_cfg, mask_cfg, optim_cfg)`` of the family."""
    from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig

    if family == "videomae":
        if tiny:
            from bvc_tpu_torch.cli.dryrun_multichip import TINY, TINY_CARD

            cfg = ModelConfig(**{**(TINY if device == "cpu" else TINY_CARD),
                                 "decoder_depth": 2})
        else:
            cfg = ModelConfig(dtype="bfloat16")
        return (cfg, MaskConfig(sampler="tube", mask_ratio=0.9),
                OptimConfig(name="sgd", lr=0.1, momentum=0.9))
    if tiny:
        cfg = ModelConfig(family="jepa", image_size=32, patch_size=8, num_frames=2,
                          tubelet_size=1, hidden_size=32, depth=2, num_heads=2, pred_depth=1,
                          pred_emb_dim=16,
                          dtype="float32" if device == "cpu" else "bfloat16")
        mask_cfg = MaskConfig(pred_mask_scale=(0.2, 0.25), min_keep=2)
    else:
        cfg = ModelConfig(family="jepa", num_frames=2, tubelet_size=1, dtype="bfloat16")
        mask_cfg = MaskConfig(enc_mask_scale=(0.85, 1.0), pred_mask_scale=(0.1, 0.2))
    return cfg, mask_cfg, OptimConfig(name="sgd", lr=0.03, momentum=0.9)


def _report(family: str, name: str, shape: dict, mode: str, accum: int, args) -> dict:
    """This rank's report of one layout: the JAX tool's row."""
    import copy

    from bvc_tpu_torch.parallel.analysis import tree_bytes
    from bvc_tpu_torch.parallel.mesh import make_mesh
    from bvc_tpu_torch.training.state import TrainState

    mesh = make_mesh(shape)
    cfg, mask_cfg, optim = _configs(family, args.tiny, args.device)
    if mode == "seq":
        cfg = dataclasses.replace(cfg, num_frames=max(cfg.num_frames, 4 * cfg.tubelet_size))
    B = args.batch * accum
    video = torch.zeros((B, cfg.num_frames, cfg.image_size, cfg.image_size, cfg.in_channels),
                        dtype=torch.uint8)
    if family == "videomae":
        from bvc_tpu_torch.models.videomae import VideoMAEPretrain

        model, target = VideoMAEPretrain(cfg, seed=0), None
    else:
        from bvc_tpu_torch.models.jepa import JEPA

        model = JEPA(cfg, seed=0)
        target = copy.deepcopy(model.encoder)
    param_bytes = tree_bytes(model)
    if mode == "seq":
        from bvc_tpu_torch.parallel.seqpar import make_seq_videomae_train_step

        step = make_seq_videomae_train_step(cfg, mask_cfg, mesh=mesh)
        batch = (video[:, step.time_slice],)
    elif mode == "pipe":
        from bvc_tpu_torch.parallel.pipeline import make_pipe_videomae_train_step

        step = make_pipe_videomae_train_step(cfg, mask_cfg, num_microbatches=2, mesh=mesh)
        batch = (video,)
    elif family == "videomae":
        from bvc_tpu_torch.training.steps import make_videomae_train_step

        step = make_videomae_train_step(cfg, mask_cfg, grad_accum=accum)
        batch = (video,)
    else:
        from bvc_tpu_torch.masks.multiblock import mask_collate
        from bvc_tpu_torch.training.steps import make_jepa_train_step

        step = make_jepa_train_step(cfg, total_steps=1000, grad_accum=accum)
        idx = mask_collate(cfg, mask_cfg, seed=0)(B * mesh.axis_size("data"), 0)
        d = mesh.coord("data")
        batch = ({"video": video, **{k: torch.from_numpy(v[d * B:(d + 1) * B])
                                     for k, v in idx.items()}},)
    sharding = mode if mode in ("replicated", "fsdp", "tp") else "replicated"
    state = TrainState.create(model, optim, seed=1, device=args.device, target=target,
                              param_sharding=sharding, mesh=mesh)
    step(state, *batch)  # DDP all-reduces one bucket in its first step, then rebuilds them
    report = step.comm_report(state, *batch)
    del state
    gc.collect()
    if args.device == "cuda":
        torch.cuda.empty_cache()
    s = report.summary()
    return {"layout": name, "param_bytes": param_bytes,
            "by_kind": {k: {kk: (round(vv, 1) if isinstance(vv, float) else vv)
                            for kk, vv in v.items()} for k, v in s["by_kind"].items()},
            "total_payload_bytes": s["total_payload_bytes"],
            "ring_bytes_per_chip": round(s["total_ring_bytes_per_chip"], 1),
            "large_collectives_in_scan": sum(op.payload_bytes >= BIG for op in report.loop_ops)}


def _mb(b: float) -> str:
    return f"{b / 1e6:.1f} MB"


def table(rows: list[dict]) -> list[str]:
    """The JAX tool's markdown table of ``rows`` (a broadcast column when a
    row has one)."""
    kinds = ["all-reduce", "all-gather", "reduce-scatter", "collective-permute"]
    heads = ["all-reduce", "all-gather", "reduce-scatter", "ppermute"]
    if any("broadcast" in r["by_kind"] for r in rows):
        kinds.append("broadcast")
        heads.append("broadcast")

    def cell(r, kind):
        d = r["by_kind"].get(kind)
        return f"{d['count']}x {_mb(d['payload_bytes'])}" if d else "—"

    lines = ["| layout | " + " | ".join(heads) + " | ring bytes/chip/step | in-scan |",
             "|---" * (len(heads) + 3) + "|"]
    for r in rows:
        lines.append(f"| {r['layout']} | " + " | ".join(cell(r, k) for k in kinds)
                     + f" | {_mb(r['ring_bytes_per_chip'])} | {r['large_collectives_in_scan']} |")
    return lines


def run_rank(args) -> list[str]:
    """Every layout's report on this rank: its JSON lines (or why a layout
    was skipped), then the table; rank 0 prints them."""
    from bvc_tpu_torch.parallel.mesh import rank, world_size

    rows, lines = [], []
    for name, shape, mode, accum in layouts(world_size(), args.family):
        if shape is None:
            lines.append(f"skipped {name}: {world_size()} ranks cannot hold it")
        else:
            rows.append(_report(args.family, name, shape, mode, accum, args))
            lines.append(json.dumps(rows[-1]))
        if rank() == 0:
            print(lines[-1], flush=True)
    if rank() == 0:
        print("\n" + "\n".join(table(rows)), flush=True)
    return lines + [""] + table(rows)


def main(argv=None) -> list[str]:
    """Start ``--n`` ranks and report every layout; rank 0's lines (raises
    when a rank fails).  Run as a rank (the rendezvous variables set), join
    the group and report."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    from bvc_tpu_torch.parallel.mesh import distributed_init
    from bvc_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device if args.device == "cpu" else None)
    if "RANK" in os.environ:
        distributed_init(backend=args.backend, device=device)
        try:
            return run_rank(args)
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if device.type == "cuda" and args.backend != "gloo" and cards < args.n:
        raise RuntimeError(f"--n {args.n} needs {args.n} GPUs over NCCL, this host has {cards}; "
                           "pass --backend gloo to share them, or --device cpu")
    logs = run_local_ranks(MODULE, argv, args.n, args.timeout,
                           cards=cards if args.backend == "gloo" else 0)
    out = logs[0].splitlines()
    lines = ([line for line in out if line.startswith(("{", "skipped"))] + [""]
             + [line for line in out if line.startswith("|")])
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
