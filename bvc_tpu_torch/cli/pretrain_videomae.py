"""CLI: VideoMAE tube-masked pretraining, one curriculum stage, on one GPU
or over several under torchrun (``--mesh data=N[,model=M]``,
``--param_sharding``)
(counterpart of :mod:`bvc_tpu.cli.pretrain_videomae`, the same flags).

Example::

    python -m bvc_tpu_torch.cli.pretrain_videomae \
        -train_group g0 -jpg_root /data/homeview -savedir out/ \
        --run_id dev_1_g0_default_0_0 --n_epoch 5 --max_epoch_iters 2000

``--architecture hiera`` trains Hiera's video MAE
(:class:`~bvc_tpu_torch.models.hiera.HieraMAE`) at Hiera-H's published
layout (:data:`~bvc_tpu_torch.models.hiera.HIERA_H`), masking whole mask
units (``--mask_sampler mask_unit``, its default there); the Hiera flags
below change the layout, each left unset keeping the preset's value, and
act on nothing else.

Runs on ``cuda``; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import json

import torch

from bvc_tpu_torch.cli.common import base_parser, to_train_config
from bvc_tpu_torch.models.hiera import HIERA_H
from bvc_tpu_torch.parallel.mesh import distributed_init
from bvc_tpu_torch.training.trainer_videomae import run_pretraining


def build_parser():
    p = base_parser("Train VideoMAE on HeadCam data (GPU)")
    p.add_argument("--mask_sampler", type=str, default=None,
                   help="tube|random|mask_unit (default: tube; mask_unit for hiera)")
    p.add_argument("--mask_ratio", type=float, default=0.9)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--tubelet_size", type=int, default=2)
    p.add_argument("--architecture", type=str, default="base")
    p.add_argument("--keep_val", type=str, default="n")
    p.add_argument("--save_every_epoch", type=str, default="n")
    p.add_argument("--resume", type=str, default="n",
                   help="y: pick up from this run's own checkpoint if present")
    hiera = p.add_argument_group("hiera", "the stage layout of --architecture hiera "
                                          "(unset: Hiera-H's)")
    for flag, kind, n in (("hidden_size", int, None), ("patch_size", int, None),
                          ("stage_depths", int, "+"), ("stage_heads", int, "+"),
                          ("dim_mul", float, None), ("q_pool", int, None),
                          ("q_stride", int, 3), ("mask_unit_size", int, 3),
                          ("mask_unit_attn", int, "+"), ("patch_kernel", int, 3),
                          ("patch_padding", int, 3), ("decoder_hidden_size", int, None),
                          ("decoder_depth", int, None), ("decoder_num_heads", int, None)):
        hiera.add_argument(f"--{flag}", type=kind, nargs=n, default=None)
    return p


def hiera_fields(args) -> dict:
    """Hiera-H's layout with the Hiera flags given laid over it
    (``--mask_unit_attn`` as 0/1 a stage)."""
    out = dict(HIERA_H)
    for k in out:
        v = getattr(args, k, None)
        if v is None:
            continue
        if k == "mask_unit_attn":
            v = tuple(bool(x) for x in v)
        out[k] = tuple(v) if isinstance(v, list) else v
    return out


def config_from_args(args):
    cfg = to_train_config(args)
    cfg.model.family = "videomae"
    cfg.model.architecture = args.architecture or "base"
    cfg.model.num_frames = args.num_frames
    cfg.model.tubelet_size = args.tubelet_size
    # HF VideoMAEConfig default eps (reference get_config leaves it default)
    cfg.model.layer_norm_eps = 1e-12
    cfg.mask.sampler = args.mask_sampler or "tube"
    if cfg.model.architecture == "hiera":
        for k, v in hiera_fields(args).items():
            setattr(cfg.model, k, v)
        cfg.mask.sampler = args.mask_sampler or "mask_unit"
    # NOTE the reference hard-codes mask_ratio=0.9 regardless of the flag
    # (pretrain_videomae.py:240); the flag is honoured.
    cfg.mask.mask_ratio = args.mask_ratio
    cfg.data.num_frames = args.num_frames
    cfg.data.tubelet_size = cfg.model.tubelet_size
    cfg.data.keep_val = args.keep_val == "y"
    cfg.save_every_epoch = args.save_every_epoch == "y"
    cfg.resume = args.resume == "y"
    if not cfg.run_id:
        cfg.run_id = f"na_1_{args.train_group}_{args.condition}_{args.fold}_{args.seed}"
    return cfg


def main(argv=None, device: str | torch.device | None = None):
    """Parse ``argv``, join the launcher's process group (torchrun; none
    in one process), train one stage on ``device`` (``cuda`` when None, the
    rank's GPU under torchrun), print the summary JSON and return it."""
    distributed_init(device=device)
    cfg = config_from_args(build_parser().parse_args(argv))
    summary = run_pretraining(cfg, device=device)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
