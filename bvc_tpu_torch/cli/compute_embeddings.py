"""CLI: embedding extraction over benchmark datasets, on one GPU or data
parallel over several (counterpart of :mod:`bvc_tpu.cli.compute_embeddings`,
the same flags).

One entry point for the reference's three extractors
(``benchmarks/compute_embeddings_{videomae,jepa,simclr}.py``; flags at
``compute_embeddings_videomae.py:292-361``), selected by ``--family``: a
single checkpoint, the untrained baseline (``-init_checkpoint_path na``),
or a ``--checkpoint_dir`` sweep over every ``model_*.pth.tar`` in it (the
port's checkpoints, and ``bvc_tpu/cli/export_torch.py``'s; the JAX CLI
sweeps its Orbax ``model_*.ckpt``).  ``--mesh data=N`` under ``torchrun
--nproc_per_node N`` embeds each rank's strided slice of every split and
rank 0 writes the CSVs; with ``--resume y`` every rank adopts rank 0's list
of splits still to run.  A ``seq`` mesh comes with slice 7c.

Example::

    python -m bvc_tpu_torch.cli.compute_embeddings -ds_task cifar10 \
        -vid_root /data/cifar -savedir emb/ --family simclr \
        -init_checkpoint_path out/model_dev_1_g0_default_0_0.pth.tar

Runs on ``cuda``; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from bvc_tpu_torch.cli.common import parse_mesh
from bvc_tpu_torch.evalbench.extract import (extract_embeddings, make_embed_fn,
                                             make_task_dataset, save_results,
                                             untrained_embed_fn)
from bvc_tpu_torch.parallel.collectives import all_gather_objects
from bvc_tpu_torch.parallel.mesh import distributed_init, make_mesh
from bvc_tpu_torch.utils.config import VIT_DIMS, ModelConfig, run_id_from_checkpoint
from bvc_tpu_torch.utils.logging import get_logger, is_main_process


def build_parser():
    p = argparse.ArgumentParser(description="Compute embeddings on benchmark data (GPU)")
    p.add_argument("-ds_task", type=str, required=True,
                   help="ssv2|toybox|tb_cat|ucf101|cifar10")
    p.add_argument("-vid_root", type=str, required=True)
    p.add_argument("-init_checkpoint_path", type=str, default="na")
    p.add_argument("-savedir", type=str, required=True)
    p.add_argument("--family", type=str, default="videomae",
                   help="videomae|jepa|simclr")
    p.add_argument("--checkpoint_dir", type=str, default="",
                   help="embed with every model_*.pth.tar in this directory")
    p.add_argument("--dataset_split", type=str, default="both",
                   help="train|test|both")
    p.add_argument("--frame_rate", type=int, default=12)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--tubelet_size", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=6)
    p.add_argument("--architecture", type=str, default="base")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--run_id", type=str, default="")
    p.add_argument("--annotation_path", type=str, default="")
    p.add_argument("--ucf_fold", type=int, default=1,
                   help="UCF101 train/test fold (dsdatasets.py:238)")
    p.add_argument("--mesh", type=str, default="",
                   help="data=N under torchrun --nproc_per_node N: data-parallel "
                        "extraction; empty: every process on data")
    p.add_argument("--quantize", type=str, default="none",
                   help="'int8': the W8A8 path of the ViT families (ops/quant.py); "
                        "'none' keeps bf16")
    p.add_argument("--resume", type=str, default="n",
                   help="y: skip (checkpoint, phase) pairs whose embeddings CSV "
                        "already exists")
    return p


def model_config_from_args(args) -> ModelConfig:
    cfg = ModelConfig(family=args.family, num_frames=args.num_frames,
                      tubelet_size=args.tubelet_size, image_size=args.image_size)
    if args.family == "videomae":
        cfg.architecture = args.architecture or "base"
        cfg.layer_norm_eps = 1e-12
    elif args.family == "jepa":
        name = (args.architecture if args.architecture.startswith("vit_")
                else "vit_" + args.architecture)
        cfg.architecture = name
        cfg.hidden_size, cfg.depth, cfg.num_heads = VIT_DIMS[name]
    else:
        cfg.architecture = (args.architecture if args.architecture.startswith("resnet")
                            else "resnet18")
    return cfg


def main(argv=None, device: str | torch.device | None = None):
    """Parse ``argv``, join the launcher's process group (torchrun; none in
    one process), embed the task's splits with each checkpoint on
    ``device`` (``cuda`` when None, the rank's GPU under torchrun), print
    the list of CSVs written as JSON and return it (rank 0's; the others
    write nothing and return an empty list)."""
    distributed_init(device=device)
    args = build_parser().parse_args(argv)
    mesh_shape = parse_mesh(args.mesh)
    world = make_mesh(mesh_shape).size
    logger = get_logger("bvc_tpu_torch.compute_embeddings")
    model_cfg = model_config_from_args(args)
    if args.checkpoint_dir:
        ckpts = sorted(str(p) for p in Path(args.checkpoint_dir).glob("model_*.pth.tar"))
    elif args.init_checkpoint_path != "na":
        ckpts = [args.init_checkpoint_path]
    else:
        ckpts = ["na"]
    phases = ["train", "test"] if args.dataset_split == "both" else [args.dataset_split]

    def csv_exists(phase: str, run_id: str) -> bool:
        out_dir = Path(args.savedir) / ("test" if phase == "test" else "")
        return (out_dir / f"embeddings_{run_id}.csv").exists()

    results = []
    for ckpt in ckpts:
        if ckpt == "na":
            run_id = args.run_id or f"untrained_0_na_na_0_{args.seed}"
        else:
            run_id = args.run_id or run_id_from_checkpoint(ckpt)
        todo = list(phases)
        if args.resume == "y":
            # preemption recovery for long sweeps: a (checkpoint, phase)
            # whose CSV is on disk is done.  Only rank 0 writes CSVs, so
            # every rank adopts rank 0's view: a rank's own check could
            # leave it out of a split its peers extract
            todo = [ph for ph in phases if not csv_exists(ph, run_id)]
            if world > 1:
                todo = all_gather_objects(todo)[0]
            for ph in phases:
                if ph not in todo:
                    logger.info("skip %s/%s (embeddings CSV exists)", run_id, ph)
            if not todo:
                continue  # checkpoint never loaded — the expensive part
        if ckpt == "na":
            embed_fn = untrained_embed_fn(args.family, model_cfg, args.seed, device=device,
                                          quantize=args.quantize, mesh_shape=mesh_shape)
        else:
            embed_fn = make_embed_fn(args.family, ckpt, model_cfg, device=device,
                                     quantize=args.quantize, mesh_shape=mesh_shape)
        for phase in todo:
            dataset = make_task_dataset(
                args.ds_task, args.vid_root, args.frame_rate, args.num_frames,
                train=(phase == "train"), image_size=args.image_size,
                annotation_path=args.annotation_path, fold=args.ucf_fold)
            logger.info("extracting %s/%s: %d samples (ckpt=%s)", args.ds_task, phase,
                        len(dataset), ckpt)
            fnames, embs = extract_embeddings(embed_fn, dataset, args.batch_size,
                                              args.num_workers)
            if is_main_process():
                path = save_results(fnames, embs, phase, run_id, args.savedir)
                logger.info("saved %s (%d rows)", path, len(fnames))
                results.append({"checkpoint": ckpt, "phase": phase, "csv": path,
                                "rows": len(fnames)})
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
