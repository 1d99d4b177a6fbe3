"""CLI: (V-)JEPA pretraining, one curriculum stage, on one GPU
or over several under torchrun (``--mesh data=N[,model=M]``,
``--param_sharding``) (counterpart
of :mod:`bvc_tpu.cli.pretrain_jepa`, the same flags).

Scale flags mirror the reference's squashed parameterisation:
``--pred_mask_scale p`` → (p, p+0.05), ``--enc_mask_scale e`` → (e, e+0.15)
(``pretrain_jepa.py:186-189``).  Runs on ``cuda``;
``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import json

import torch

from bvc_tpu_torch.cli.common import base_parser, to_train_config
from bvc_tpu_torch.parallel.mesh import distributed_init
from bvc_tpu_torch.training.trainer_jepa import run_pretraining
from bvc_tpu_torch.utils.config import VIT_DIMS


def build_parser():
    p = base_parser("Train V-JEPA on HeadCam data (GPU)")
    p.add_argument("--num_frames", type=int, default=2)
    p.add_argument("--tubelet_size", type=int, default=1)
    p.add_argument("--architecture", type=str, default="base",
                   help="vit size suffix: tiny|small|base|large|huge|giant")
    p.add_argument("--enc_mask_scale", type=float, default=0.85)
    p.add_argument("--pred_mask_scale", type=float, default=0.1)
    p.add_argument("--allow_overlap", type=str, default="n")
    p.add_argument("--interval", type=int, default=300)
    p.add_argument("--augs", type=str, default="n")
    p.add_argument("--pred_depth", type=int, default=6)
    p.add_argument("--pred_emb_dim", type=int, default=384)
    p.add_argument("--save_every_epoch", type=str, default="n")
    p.add_argument("--resume", type=str, default="n",
                   help="y: pick up from this run's own checkpoint if present")
    return p


def config_from_args(args):
    cfg = to_train_config(args)
    cfg.model.family = "jepa"
    name = "vit_" + args.architecture
    dim, depth, heads = VIT_DIMS[name]
    cfg.model.architecture = name
    cfg.model.hidden_size = dim
    cfg.model.depth = depth
    cfg.model.num_heads = heads
    cfg.model.num_frames = args.num_frames
    cfg.model.tubelet_size = args.tubelet_size
    cfg.model.pred_depth = args.pred_depth
    cfg.model.pred_emb_dim = args.pred_emb_dim
    cfg.mask.enc_mask_scale = (args.enc_mask_scale, args.enc_mask_scale + 0.15)
    cfg.mask.pred_mask_scale = (args.pred_mask_scale, args.pred_mask_scale + 0.05)
    cfg.mask.allow_overlap = args.allow_overlap == "y"
    cfg.optim.exclude_bias_and_norm_from_wd = True
    cfg.data.num_frames = args.num_frames
    cfg.data.tubelet_size = args.tubelet_size
    cfg.data.interval = args.interval
    cfg.data.augs = args.augs
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
