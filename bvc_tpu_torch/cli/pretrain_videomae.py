"""CLI: VideoMAE tube-masked pretraining, one curriculum stage, on one GPU
(counterpart of :mod:`bvc_tpu.cli.pretrain_videomae`, the same flags).

Example::

    python -m bvc_tpu_torch.cli.pretrain_videomae \
        -train_group g0 -jpg_root /data/homeview -savedir out/ \
        --run_id dev_1_g0_default_0_0 --n_epoch 5 --max_epoch_iters 2000

Runs on ``cuda``; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import json

import torch

from bvc_tpu_torch.cli.common import base_parser, to_train_config
from bvc_tpu_torch.training.trainer_videomae import run_pretraining


def build_parser():
    p = base_parser("Train VideoMAE on HeadCam data (GPU)")
    p.add_argument("--mask_sampler", type=str, default="tube", help="tube|random")
    p.add_argument("--mask_ratio", type=float, default=0.9)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--tubelet_size", type=int, default=2)
    p.add_argument("--architecture", type=str, default="base")
    p.add_argument("--keep_val", type=str, default="n")
    p.add_argument("--save_every_epoch", type=str, default="n")
    p.add_argument("--resume", type=str, default="n",
                   help="y: pick up from this run's own checkpoint if present")
    return p


def config_from_args(args):
    cfg = to_train_config(args)
    cfg.model.family = "videomae"
    cfg.model.architecture = args.architecture or "base"
    cfg.model.num_frames = args.num_frames
    cfg.model.tubelet_size = args.tubelet_size
    # HF VideoMAEConfig default eps (reference get_config leaves it default)
    cfg.model.layer_norm_eps = 1e-12
    cfg.mask.sampler = args.mask_sampler
    # NOTE the reference hard-codes mask_ratio=0.9 regardless of the flag
    # (pretrain_videomae.py:240); the flag is honoured.
    cfg.mask.mask_ratio = args.mask_ratio
    cfg.data.num_frames = args.num_frames
    cfg.data.tubelet_size = args.tubelet_size
    cfg.data.keep_val = args.keep_val == "y"
    cfg.save_every_epoch = args.save_every_epoch == "y"
    cfg.resume = args.resume == "y"
    if not cfg.run_id:
        cfg.run_id = f"na_1_{args.train_group}_{args.condition}_{args.fold}_{args.seed}"
    return cfg


def main(argv=None, device: str | torch.device | None = None):
    """Parse ``argv``, train one stage on ``device`` (``cuda`` when None),
    print the summary JSON and return it."""
    cfg = config_from_args(build_parser().parse_args(argv))
    summary = run_pretraining(cfg, device=device)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
