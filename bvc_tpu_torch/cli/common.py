"""Shared CLI plumbing: the reference's argparse surface -> TrainConfig
(counterpart of :mod:`bvc_tpu.cli.common`, with the same flags and
defaults).

Flag names, defaults and single-dash/double-dash spelling follow the
reference entry points (``pretrain_videomae.py:383-499``,
``pretrain_jepa.py:486-607``, ``pretrain_simclr.py:390-495``) so existing
slurm invocations port over mechanically.  The multi-GPU flags (``--mesh``,
``--param_sharding``) are parsed as the JAX CLIs parse them: ``--mesh
data=N[,model=M]`` runs over N*M processes, one a GPU, launched by torchrun
(``torchrun --nproc_per_node 4 -m bvc_tpu_torch.cli.pretrain_videomae --mesh
data=2,model=2 --param_sharding tp ...``), and raises unless N*M is the
world size; ``--param_sharding`` lays the parameters out as ``replicated``
(DDP), ``zero1`` (partitioned optimizer state), ``fsdp`` (FSDP2) or ``tp``
(attention heads and MLP columns over ``model``).  The trainers refuse a
``seq`` or ``pipe`` axis, naming the slice of the port that brings it
(7c, 7d).  ``--pipe_microbatches``, which acts only on a pipe mesh, is
accepted and unused.
"""

from __future__ import annotations

import argparse

from bvc_tpu_torch.utils.config import TrainConfig


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-train_group", type=str, default="g0",
                   help="age group: g0|g1|g2|g3|gr")
    p.add_argument("-jpg_root", type=str, default="")
    p.add_argument("-savedir", type=str, default="")
    p.add_argument("-init_checkpoint_path", type=str, default="na")
    p.add_argument("--ds_rate", type=int, default=1)
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--optim", type=str, default="sgd")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--batch_size", type=int, default=16,
                   help="per-GPU batch size: the global batch is batch_size x world")
    p.add_argument("--n_epoch", type=int, default=1)
    p.add_argument("--n_trainsamples", type=int, default=81000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--condition", type=str, default="default")
    p.add_argument("--max_epoch_iters", type=int, default=0)
    p.add_argument("--run_id", type=str, default="")
    p.add_argument("--script", type=str, default="")
    p.add_argument("--num_workers", type=int, default=6)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--mesh", type=str, default="",
                   help="process layout, e.g. data=2,model=2 under torchrun "
                        "--nproc_per_node 4; empty: every process on data "
                        "(seq/pipe: slices 7c-7d)")
    p.add_argument("--param_sharding", type=str, default="replicated",
                   choices=["replicated", "zero1", "fsdp", "tp"],
                   help="parameter layout: replicated (DDP), zero1 (optimizer state "
                        "over data), fsdp (parameters over data), tp (heads over model)")
    p.add_argument("--control_data_root", type=str, default="")
    p.add_argument("--pack_root", type=str, default="",
                   help="packed-corpus root (bvc_tpu_torch.data.packed); plain "
                        "transforms read pre-resized uint8 memmaps instead of "
                        "decoding JPEGs per step")
    p.add_argument("--segment_minutes", type=float, default=30.0,
                   help="fold segment length in minutes (reference: 30)")
    p.add_argument("--log_grad_stats", type=str, default="n",
                   help="y: per-layer grad-norm stats table in the log lines")
    p.add_argument("--profile_dir", type=str, default="",
                   help="capture one torch.profiler trace of train steps 1-3 to "
                        "this dir (Chrome/Perfetto timeline, summary.json)")
    # LR/WD schedules: the reference ships I-JEPA's warmup-cosine
    # schedulers disabled (predictive/helper.py:148-161); opt-in here
    p.add_argument("--lr_schedule", type=str, default="none",
                   choices=["none", "warmup_cosine"])
    p.add_argument("--warmup_epochs", type=float, default=0.0)
    p.add_argument("--start_lr", type=float, default=0.0)
    p.add_argument("--final_lr", type=float, default=0.0)
    p.add_argument("--final_wd", type=float, default=-1.0,
                   help="cosine-decay weight decay to this value; <0 = off")
    p.add_argument("--ipe_scale", type=float, default=1.25)
    p.add_argument("--async_save", type=str, default="n",
                   help="y: write checkpoints on a background thread")
    p.add_argument("--grad_accum_steps", type=int, default=1,
                   help=">1: sequential microbatches per optimizer step "
                        "(same effective batch, less activation memory)")
    p.add_argument("--pipe_microbatches", type=int, default=4,
                   help="GPipe microbatches on a 'pipe' mesh (unused on one GPU)")
    return p


def parse_mesh(spec: str) -> dict[str, int]:
    """``'data=2'`` -> ``{'data': 2}``; ``''`` -> ``{}``.  Raises on a part
    that is not ``axis=int``."""
    if not spec:
        return {}
    out = {}
    for part in spec.split(","):
        k, sep, v = part.partition("=")
        if not sep or not k.strip():
            raise ValueError(f"--mesh {spec!r}: expected axis=size[,axis=size...]")
        try:
            out[k.strip()] = int(v)
        except ValueError:
            raise ValueError(f"--mesh {spec!r}: size of {k.strip()!r} is not an integer") \
                from None
    return out


def to_train_config(args: argparse.Namespace) -> TrainConfig:
    cfg = TrainConfig()
    cfg.run_id = args.run_id
    cfg.savedir = args.savedir
    cfg.init_checkpoint_path = args.init_checkpoint_path
    cfg.n_epoch = args.n_epoch
    cfg.max_epoch_iters = args.max_epoch_iters
    cfg.seed = args.seed
    cfg.script = args.script
    cfg.mesh_shape = parse_mesh(args.mesh)
    cfg.param_sharding = args.param_sharding
    # preemption-recovery flags (present on the pretrain CLIs)
    cfg.save_every_epoch = getattr(args, "save_every_epoch", "n") == "y"
    cfg.async_save = getattr(args, "async_save", "n") == "y"
    cfg.resume = getattr(args, "resume", "n") == "y"
    cfg.log_grad_stats = getattr(args, "log_grad_stats", "n") == "y"
    cfg.profile_dir = getattr(args, "profile_dir", "")
    cfg.pipe_microbatches = getattr(args, "pipe_microbatches", 4)

    d = cfg.data
    d.jpg_root = args.jpg_root
    d.train_group = args.train_group
    d.ds_rate = args.ds_rate
    d.fold = args.fold
    d.condition = args.condition
    d.n_trainsamples = args.n_trainsamples
    d.image_size = args.image_size
    d.batch_size = args.batch_size
    d.seed = args.seed
    d.num_workers = args.num_workers
    d.control_data_root = args.control_data_root
    d.pack_root = args.pack_root
    d.segment_minutes = args.segment_minutes

    o = cfg.optim
    o.name = args.optim
    o.lr = args.lr
    o.weight_decay = args.wd
    o.momentum = args.momentum
    o.schedule = args.lr_schedule
    o.warmup_epochs = args.warmup_epochs
    o.start_lr = args.start_lr
    o.final_lr = args.final_lr
    o.final_wd = args.final_wd if args.final_wd >= 0 else None
    o.ipe_scale = args.ipe_scale
    o.grad_accum_steps = args.grad_accum_steps
    cfg.model.image_size = args.image_size
    return cfg
