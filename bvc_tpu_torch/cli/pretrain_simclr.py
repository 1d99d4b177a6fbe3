"""CLI: SimCLR pretraining, one curriculum stage, on one GPU (counterpart of
:mod:`bvc_tpu.cli.pretrain_simclr`, the same flags).

Example::

    python -m bvc_tpu_torch.cli.pretrain_simclr \
        -train_group g0 -jpg_root /data/homeview -savedir out/ \
        --run_id dev_1_g0_default_0_0 --batch_size 256 --max_epoch_iters 2000

Runs on ``cuda``; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import json

import torch

from bvc_tpu_torch.cli.common import base_parser, to_train_config
from bvc_tpu_torch.training.trainer_simclr import run_pretraining


def build_parser():
    p = base_parser("Train SimCLR on HeadCam data (GPU)")
    p.add_argument("--architecture", type=str, default="resnet18")
    p.add_argument("--pred_emb_dim", type=int, default=512)
    p.add_argument("--interval", type=int, default=900)
    p.add_argument("--augs", type=str, default="cjo")
    p.add_argument("--negatives", type=str, default="global",
                   choices=["global", "per_replica"],
                   help="per_replica = the reference's per-rank loss (one GPU: "
                        "the same as global)")
    p.add_argument("--bn_stats", type=str, default="global",
                   choices=["global", "per_replica"],
                   help="per_replica = reference DDP per-rank BatchNorm (one GPU: "
                        "the same as global)")
    p.add_argument("--save_every_epoch", type=str, default="n")
    p.add_argument("--resume", type=str, default="n",
                   help="y: pick up from this run's own checkpoint if present")
    return p


def config_from_args(args):
    cfg = to_train_config(args)
    cfg.model.family = "simclr"
    cfg.model.architecture = args.architecture or "resnet18"
    cfg.model.pred_emb_dim = args.pred_emb_dim
    cfg.data.interval = args.interval
    cfg.data.augs = args.augs
    cfg.data.num_frames = 2
    cfg.optim.contrastive_negatives = args.negatives
    cfg.optim.bn_stats = args.bn_stats
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
