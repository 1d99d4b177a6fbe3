"""CLI: export a checkpoint's embedding function as a serving artifact
(counterpart of :mod:`bvc_tpu.cli.export_serving`, the same flags).

``python -m bvc_tpu_torch.cli.export_serving -init_checkpoint_path
model_X.pth.tar -out /artifacts/X --family videomae [--quantize int8]``

The artifact directory (a ``torch.export`` program with its weights, and
``meta.json``; :mod:`bvc_tpu_torch.serving.export`) replays the extraction
forward through ``bvc_tpu_torch.serving.load_artifact`` without the port's
model code.  ``-init_checkpoint_path`` takes a ``model_{run_id}.pth.tar``
of the port's trainers or of ``bvc_tpu/cli/export_torch.py``, or ``na`` for
a random model from ``--seed``.  An artifact runs on the one device it was
exported on: ``--platforms`` names it, ``cuda`` (the default) or ``cpu``.
``main(argv, device="cpu")`` exports on the CPU too.
"""

from __future__ import annotations

import argparse
import json

import torch

from bvc_tpu_torch.cli.compute_embeddings import model_config_from_args
from bvc_tpu_torch.evalbench.extract import init_family_model, load_family_model
from bvc_tpu_torch.serving.export import export_embed, save_artifact
from bvc_tpu_torch.utils.device import resolve_device

PLATFORMS = ("cuda", "cpu")


def build_parser():
    p = argparse.ArgumentParser(
        description="Export an embedding-serving artifact (torch.export)")
    p.add_argument("-init_checkpoint_path", type=str, required=True,
                   help="checkpoint to freeze ('na' = random init, the "
                        "untrained-baseline analogue)")
    p.add_argument("-out", type=str, required=True,
                   help="artifact directory to write")
    p.add_argument("--family", type=str, default="videomae",
                   help="videomae|jepa|simclr")
    p.add_argument("--architecture", type=str, default="base")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--tubelet_size", type=int, default=2)
    p.add_argument("--quantize", type=str, default="none",
                   help="'int8': freeze the W8A8 expansion-matmul "
                        "weights into the artifact (ViT families)")
    p.add_argument("--batch", type=int, default=0,
                   help="0 = batch-polymorphic artifact (default); N "
                        "pins the batch dimension")
    p.add_argument("--platforms", type=str, default="",
                   help="the one device the artifact runs on: 'cuda' or 'cpu'; "
                        "empty = cuda")
    p.add_argument("--seed", type=int, default=0)
    return p


def export_device(platforms: str, device: str | torch.device | None) -> str | torch.device | None:
    """The device of ``--platforms`` (one of :data:`PLATFORMS`), else
    ``device``; raises for another value, for more than one, and for a
    ``--platforms`` that contradicts ``device``."""
    names = [s.strip() for s in platforms.split(",") if s.strip()]
    if not names:
        return device
    if len(names) > 1 or names[0] not in PLATFORMS:
        raise ValueError(f"--platforms {platforms!r}: an artifact runs on the one device it "
                         f"is exported on; name one of {PLATFORMS}")
    if device is not None and torch.device(device).type != names[0]:
        raise ValueError(f"--platforms {names[0]} contradicts device={device}")
    return names[0]


def main(argv=None, device: str | torch.device | None = None):
    """Parse ``argv``, export on the device of ``--platforms`` or ``device``
    (``cuda`` when neither names one), write the artifact, print a JSON
    line and return the artifact's path."""
    args = build_parser().parse_args(argv)
    device = resolve_device(export_device(args.platforms, device))
    model_cfg = model_config_from_args(args)
    if args.init_checkpoint_path == "na":
        model = init_family_model(args.family, model_cfg, args.seed)
    else:
        model = load_family_model(args.family, args.init_checkpoint_path, model_cfg)
    exported, meta = export_embed(args.family, model, model_cfg, quantize=args.quantize,
                                  batch=args.batch or None, device=device)
    meta["checkpoint"] = args.init_checkpoint_path
    path = save_artifact(args.out, exported, meta)
    print(json.dumps({"artifact": path, **{k: meta[k] for k in
                                           ("family", "feature_dim", "quantize", "batch",
                                            "platforms")}}))
    return path


if __name__ == "__main__":
    main()
