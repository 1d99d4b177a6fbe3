"""CLI: run a full curriculum experiment (the slurmscripts replacement) on
one GPU, or over several under torchrun with ``--mesh data=N[,model=M]``
(counterpart of :mod:`bvc_tpu.cli.run_curriculum`, its flags and
``--pack_root``).

Example::

    python -m bvc_tpu_torch.cli.run_curriculum \
        -jpg_root /data/homeview -savedir out/ \
        --curriculum dev --preset generative --seed 101

Equivalent to ``sbatch slurmscripts/generative/slurm_dev_def.bash`` minus
the cluster submission; add ``--n_stages``, ``--condition`` for the
control variants, and ``--init_checkpoint_path`` to resume a chain.  The
kernels build at their first use (``bvc_tpu_torch/ops/_build.py``).
``torchrun --nproc_per_node N -m bvc_tpu_torch.cli.run_curriculum --mesh
data=N ...`` runs every stage and the sweep data parallel (rank 0 writes the
manifest), ``--mesh data=N,model=M --param_sharding tp`` over N*M ranks
with the heads split over ``model``; ``--param_sharding zero1|fsdp|tp``
reaches every stage.  ``--emit_script`` with a mesh writes commands that
launch each stage under torchrun.  A ``seq``/``pipe`` axis raises, naming
slices 7c-7d.

Runs on ``cuda``; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from bvc_tpu_torch.cli.common import parse_mesh
from bvc_tpu_torch.curriculum.driver import run_curriculum
from bvc_tpu_torch.curriculum.presets import CURRICULA, FAMILY_PRESETS
from bvc_tpu_torch.parallel.mesh import distributed_init
from bvc_tpu_torch.utils.config import TrainConfig


def build_parser():
    p = argparse.ArgumentParser(description="Run a curriculum experiment (GPU)")
    p.add_argument("-jpg_root", type=str, required=True)
    p.add_argument("-savedir", type=str, required=True)
    p.add_argument("--curriculum", type=str, default="dev",
                   choices=sorted(CURRICULA.keys()))
    p.add_argument("--preset", type=str, default="generative",
                   choices=sorted(FAMILY_PRESETS.keys()))
    p.add_argument("--condition", type=str, default="default")
    p.add_argument("--n_stages", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init_checkpoint_path", type=str, default="na")
    p.add_argument("--num_workers", type=int, default=6)
    p.add_argument("--control_data_root", type=str, default="")
    p.add_argument("--mesh", type=str, default="",
                   help="data=N under torchrun --nproc_per_node N (every stage and the "
                        "sweep data parallel); with --emit_script, the commands' layout")
    p.add_argument("--param_sharding", type=str, default="replicated",
                   help="every stage's parameter layout: replicated, zero1, fsdp or tp")
    p.add_argument("--segment_minutes", type=float, default=30.0)
    p.add_argument("--pack_root", type=str, default="",
                   help="packed-corpus root (python -m bvc_tpu_torch.cli.pack_corpus): "
                        "the stages' plain transforms read its pre-resized frames "
                        "instead of decoding JPEGs; the live run only (with "
                        "--emit_script it raises)")
    p.add_argument("--extract", type=str, default="",
                   help="benchmark extraction after the stages, e.g. "
                        "'ssv2=/data/ssv2,toybox=/data/toybox' (the bash "
                        "scripts' final --checkpoint_dir sweep)")
    p.add_argument("--untrained_baseline", type=str, default="n",
                   help="y: stage-0 extraction from random init")
    p.add_argument("--frame_rate", type=int, default=12)
    p.add_argument("--extract_batch_size", type=int, default=64)
    p.add_argument("--extract_quantize", type=str, default="none",
                   help="'int8': run the post-stage extraction sweep on "
                        "the W8A8 inference path (ViT families; "
                        "compute_embeddings --quantize analogue)")
    p.add_argument("--save_every_epoch", type=str, default="n",
                   help="y: per-epoch checkpoints inside each stage")
    p.add_argument("--resume", type=str, default="n",
                   help="y: curriculum-level preemption recovery — "
                        "completed stages are skipped via their "
                        "checkpoints and the interrupted stage resumes "
                        "mid-run (requires --save_every_epoch y for "
                        "sub-stage granularity)")
    p.add_argument("--emit_script", type=str, default="",
                   help="write the curriculum as a runnable shell script "
                        "(the reference's slurmscripts analogue) to this "
                        "path and exit without training")
    p.add_argument("--sbatch", type=str, default="n",
                   help="y: prepend an #SBATCH header to --emit_script "
                        "output (reference slurm_dev_def.bash:1-14 "
                        "analogue, gpu partition, one GPU)")
    p.add_argument("--job_name", type=str, default="",
                   help="SBATCH job name (default job_{seed}_{curr}_{preset})")
    p.add_argument("--override", type=str, default="",
                   help="comma-separated preset overrides, e.g. "
                        "'n_epoch=1,max_epoch_iters=3,n_trainsamples=64,"
                        "batch_size=2' — for smoke runs and ablations")
    return p


def _parse_extract(args) -> list[dict] | None:
    """One parser for the ``--extract 'task=root,...'`` spec (used by both
    the live run and the emitted script)."""
    if not args.extract:
        return None
    return [
        {"ds_task": part.split("=", 1)[0].strip(),
         "vid_root": part.split("=", 1)[1].strip(),
         "frame_rate": args.frame_rate,
         "batch_size": args.extract_batch_size,
         "quantize": getattr(args, "extract_quantize", "none")}
        for part in args.extract.split(",")
    ]


def main(argv=None, device: str | torch.device | None = None):
    """Parse ``argv``; emit the script, or join the launcher's process group
    (torchrun; none in one process) and run the curriculum on ``device``
    (``cuda`` when None, the rank's GPU under torchrun), print the final
    checkpoint as JSON and return the manifest."""
    args = build_parser().parse_args(argv)
    preset = FAMILY_PRESETS[args.preset]
    if args.override:
        from bvc_tpu_torch.curriculum.presets import apply_overrides

        preset = apply_overrides(preset, args.override)
    extraction = _parse_extract(args)
    if args.emit_script:
        from bvc_tpu_torch.curriculum.driver import emit_script

        if args.pack_root:
            raise ValueError("--pack_root applies to the live run only: the emitted "
                             "script's stages decode the JPEGs under -jpg_root")

        script = emit_script(
            args.curriculum, preset, args.seed,
            jpg_root=args.jpg_root, savedir=args.savedir,
            condition=args.condition, n_stages=args.n_stages,
            extract={t["ds_task"]: t["vid_root"] for t in extraction or []},
            init_checkpoint_path=args.init_checkpoint_path,
            control_data_root=args.control_data_root,
            frame_rate=args.frame_rate,
            extract_batch_size=args.extract_batch_size,
            extract_quantize=args.extract_quantize,
            preset_name=args.preset,
            sbatch=args.sbatch == "y",
            job_name=args.job_name or None,
            mesh=args.mesh,
            param_sharding=args.param_sharding,
        )
        with open(args.emit_script, "w") as f:
            f.write(script)
        print(json.dumps({"emitted": args.emit_script,
                          "stages": args.n_stages}))
        return {"emitted": args.emit_script}
    distributed_init(device=device)
    base = TrainConfig(savedir=args.savedir, seed=args.seed)
    base.save_every_epoch = args.save_every_epoch == "y"
    base.resume = args.resume == "y"
    base.data.jpg_root = args.jpg_root
    base.data.seed = args.seed
    base.data.num_workers = args.num_workers
    base.data.control_data_root = args.control_data_root
    base.data.segment_minutes = args.segment_minutes
    base.data.pack_root = args.pack_root
    base.param_sharding = args.param_sharding
    base.mesh_shape = parse_mesh(args.mesh)
    results = run_curriculum(
        args.curriculum, preset, base,
        n_stages=args.n_stages, condition=args.condition,
        init_checkpoint_path=args.init_checkpoint_path,
        extraction=extraction,
        untrained_baseline=args.untrained_baseline == "y",
        device=device,
    )
    print(json.dumps({"final_checkpoint": results["final_checkpoint"]}))
    return results


if __name__ == "__main__":
    main()
