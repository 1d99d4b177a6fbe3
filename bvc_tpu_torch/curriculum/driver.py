"""Curriculum driver: the reference's bash stage loop as a Python L5, on
one GPU or over several (counterpart of
:mod:`bvc_tpu.curriculum.driver`).

Replaces ``slurmscripts/*/slurm_*_*.bash`` (SURVEY.md §2.8, §3.5):

- optional stage-0 untrained-baseline embedding extraction
  (``slurm_dev_def.bash:68-87``),
- stages 1..3: pretrain on the curriculum's group for that stage, thread
  the saved checkpoint into the next stage via
  ``init_checkpoint_path`` (``:100-103``),
- per-stage fold rotation ``fold = (seed + stage) % 3`` (``:96``),
- run-id contract ``{curr}_{stage}_{group}_{condition}_{fold}_{seed}``
  (``:99``),
- per-stage overrides (contrastive lr/interval schedule),
- optional final embedding extraction sweep over all stage checkpoints
  (``:165-177``).

Cross-stage state: the reference resumes only weights for
generative/contrastive but weights+optimizer+EMA+collator-counter for
JEPA (``pretrain_jepa.py:290-300``); the trainers already implement that
per-family behavior, the driver just wires paths.

The port's stages run the port's trainers (``training/trainer_*.py``) and
write ``model_{run_id}.pth.tar``; the sweep runs ``evalbench/extract.py``.
Under a process group (torchrun) every rank runs the curriculum: the stages
over ``base.mesh_shape`` (``data``; ``data`` and ``model``; ``data`` and
``seq``, with or without ``model``; or ``data`` and ``pipe``: sizes that
multiply to the world size) with ``base.param_sharding``'s layout, the
sweep over its ``data`` axis, and rank 0 writes the manifest and the CSVs.
The ranks of the other axes (``model``, ``pipe``) of a data row extract
the same clips, as the JAX sweep replicates its embed over them; a
``seq`` ring splits each clip's time axis.  A layout the mesh cannot take
raises before anything runs.  :func:`emit_script` launches each stage and
sweep under ``torchrun --nproc_per_node N`` when its ``mesh`` asks for
N > 1 ranks.
"""

from __future__ import annotations

import copy
import json
import math
import shlex
from pathlib import Path
from typing import Any

import torch

from bvc_tpu_torch.cli.common import parse_mesh
from bvc_tpu_torch.curriculum.presets import (
    CONDITION_FRAME_OVERRIDES,
    CURRICULA,
    FAMILY_PRESETS,
    FamilyPreset,
)
from bvc_tpu_torch.parallel.mesh import check_axes
from bvc_tpu_torch.training.stage import run_mesh
from bvc_tpu_torch.utils.config import VIT_DIMS, RunId, TrainConfig
from bvc_tpu_torch.utils.device import resolve_device
from bvc_tpu_torch.utils.logging import get_logger, is_main_process


def stage_plan(
    curriculum: str,
    preset: FamilyPreset,
    seed: int,
    condition: str = "default",
    n_stages: int = 3,
) -> list[dict[str, Any]]:
    """The per-stage parameter plan (group, fold, run_id, overrides)."""
    groups = CURRICULA[curriculum]
    plan = []
    for stage in range(1, n_stages + 1):
        group = groups[(stage - 1) % len(groups)]
        fold = (seed + stage) % 3
        overrides = dict(preset.stage_overrides.get(stage - 1, {}))
        rid = RunId(curriculum, stage, group, condition, fold, seed)
        plan.append({
            "stage": stage,
            "train_group": group,
            "fold": fold,
            "run_id": str(rid),
            "overrides": overrides,
        })
    return plan


def build_stage_config(
    preset: FamilyPreset,
    stage_info: dict[str, Any],
    base: TrainConfig,
) -> TrainConfig:
    """Materialise one stage's TrainConfig from preset + plan + base."""
    cfg = copy.deepcopy(base)
    cfg.run_id = stage_info["run_id"]
    cfg.n_epoch = preset.n_epoch
    cfg.max_epoch_iters = preset.max_epoch_iters

    d = cfg.data
    d.train_group = stage_info["train_group"]
    d.fold = stage_info["fold"]
    d.n_trainsamples = preset.n_trainsamples
    d.batch_size = preset.batch_size
    d.num_frames = preset.num_frames
    d.tubelet_size = preset.tubelet_size
    d.augs = preset.augs
    d.interval = preset.interval

    m = cfg.model
    m.family = preset.family
    m.num_frames = preset.num_frames
    m.tubelet_size = preset.tubelet_size
    hiera = preset.family == "videomae" and m.architecture == "hiera"
    if preset.family == "videomae" and not hiera:  # Hiera keeps its own eps
        m.layer_norm_eps = 1e-12
    if preset.family == "jepa":
        name = "vit_" + preset.architecture if not preset.architecture.startswith("vit_") else preset.architecture
        m.architecture = name
        m.hidden_size, m.depth, m.num_heads = VIT_DIMS[name]
        cfg.optim.exclude_bias_and_norm_from_wd = True
    elif preset.family == "simclr":
        m.architecture = preset.architecture
        m.pred_emb_dim = preset.pred_emb_dim

    cfg.mask.sampler = "mask_unit" if hiera else preset.mask_sampler
    cfg.mask.mask_ratio = preset.mask_ratio
    cfg.mask.enc_mask_scale = (preset.enc_mask_scale, preset.enc_mask_scale + 0.15)
    cfg.mask.pred_mask_scale = (preset.pred_mask_scale, preset.pred_mask_scale + 0.05)
    cfg.mask.allow_overlap = preset.allow_overlap

    cfg.optim.name = preset.optim
    cfg.optim.lr = preset.lr
    cfg.optim.momentum = preset.momentum
    cfg.optim.weight_decay = preset.wd

    if cfg.data.condition in CONDITION_FRAME_OVERRIDES:
        for k, v in CONDITION_FRAME_OVERRIDES[cfg.data.condition].items():
            setattr(d, k, v)
            setattr(m, k, v)

    for k, v in stage_info["overrides"].items():
        for sub in (cfg.optim, d, m, cfg):
            if hasattr(sub, k):
                setattr(sub, k, v)
                break
        else:
            raise ValueError(f"unknown stage override {k!r}")
    return cfg


_FAMILY_CLI = {"videomae": "pretrain_videomae", "jepa": "pretrain_jepa",
               "simclr": "pretrain_simclr"}


def emit_script(
    curriculum: str,
    preset: "str | FamilyPreset",
    seed: int,
    jpg_root: str = "$JPG_ROOT",
    savedir: str = "$SAVEDIR",
    condition: str = "default",
    n_stages: int = 3,
    extract: dict[str, str] | None = None,
    init_checkpoint_path: str = "na",
    control_data_root: str = "",
    frame_rate: int = 12,
    extract_batch_size: int = 64,
    extract_quantize: str = "none",
    preset_name: str | None = None,
    sbatch: bool = False,
    job_name: str | None = None,
    mesh: str = "",
    param_sharding: str = "replicated",
) -> str:
    """The curriculum as a runnable shell script — the reference ships its
    grids as bash (``slurmscripts/*``); this emits the equivalent over
    this framework's CLIs (SURVEY.md §7.6 "a config-driven runner that
    can also emit job scripts") for users who schedule via job files.

    ``preset`` may be a registry name or a FamilyPreset instance (so CLI
    ``--override`` edits reach the script; pass ``preset_name`` alongside
    so the provenance header names the registry entry, not the model
    family).  ``frame_rate``/``extract_batch_size`` reach the emitted
    extraction commands — the live run threads the same values into
    ``_run_extraction``, and omitting them would make the script sample
    benchmarks at the CLI defaults instead.  Matched* control conditions
    additionally emit ``--control_data_root`` (env-overridable).

    ``sbatch=True`` prepends an ``#SBATCH`` header mirroring the
    reference's (``slurmscripts/generative/slurm_dev_def.bash:1-14``:
    1 node, 40 CPUs, 1d05h wall limit, mail on FAIL) on its cluster's
    ``gpu`` partition with one GPU (``--gres=gpu:1``: a stage trains on one
    GPU); without it the script is a plain shell runner.  The reference's
    staggered-sleep preamble (``:26-30``, avoiding NCCL port collisions
    between concurrent jobs) is not mirrored: one process a job opens no
    rendezvous port.

    The script runs the port's CLIs and threads ``model_{run_id}.pth.tar``
    from stage to stage; it is otherwise the JAX package's, line for line.
    ``mesh`` (the CLI's ``--mesh``, e.g. ``'data=4'``, ``'data=2,model=2'``
    or ``'data=2,pipe=2'``) reaches every command; when it asks for more than
    one rank, each command runs under ``torchrun --nproc_per_node N`` with
    N the product of its sizes (and the ``#SBATCH`` header asks for N
    GPUs).  ``param_sharding`` other than ``replicated`` reaches every
    stage's command.
    """
    from bvc_tpu_torch.data.factory import CONTROL_CONDITIONS

    if preset_name is None:
        preset_name = preset if isinstance(preset, str) else preset.family
    if isinstance(preset, str):
        preset = FAMILY_PRESETS[preset]
    plan = stage_plan(curriculum, preset, seed, condition, n_stages)
    cli = _FAMILY_CLI[preset.family]
    mesh_shape = parse_mesh(mesh)
    check_axes(mesh_shape)
    ranks = math.prod(max(n, 1) for n in mesh_shape.values())
    launch = (f"torchrun --nproc_per_node {ranks} -m" if ranks > 1 else "python -m")
    mesh_flag = f" --mesh {mesh}" if mesh else ""
    shard_flag = (f" --param_sharding {param_sharding}"
                  if param_sharding != "replicated" else "")
    # 'static' also routes through the control root once one is
    # configured (data/factory.py); emitting the env-backed flag for it
    # keeps script semantics identical to the live run either way
    needs_control_root = preset.family == "videomae" and (
        condition in CONTROL_CONDITIONS or condition == "static"
    )
    # map to the reference's actual slurmscripts directory — registry
    # names mostly match, family names (the instance-only fallback) and
    # predictive_unt do not (its grid lives in predictive/slurm_unt_*)
    ref_dir = {
        "videomae": "generative", "jepa": "predictive",
        "simclr": "contrastive", "predictive_unt": "predictive",
    }.get(preset_name, preset_name)
    ref_script = ("slurm_unt_def.bash" if preset_name == "predictive_unt"
                  else f"slurm_{curriculum}_def.bash")
    header: list[str] = []
    if sbatch:
        name = job_name or f"job_{seed}_{curriculum}_{preset_name}"
        header = [
            f"#SBATCH --job-name={name}",
            f"#SBATCH --output={name}_Out",
            f"#SBATCH --error={name}_Err",
            "#SBATCH --nodes=1",
            "#SBATCH --ntasks-per-node=1",
            "#SBATCH --cpus-per-task=40",
            "#SBATCH --time=1-05:00:00",
            "#SBATCH --partition=gpu",
            f"#SBATCH --gres=gpu:{ranks}",
            "#SBATCH --mail-type=FAIL",
        ]
    lines = [
        "#!/bin/bash",
        *header,
        f"# {curriculum} curriculum, preset {preset_name}, seed {seed}, "
        f"condition {condition} —",
        f"# generated by bvc_tpu_torch.curriculum.emit_script (reference "
        f"analogue: slurmscripts/{ref_dir}/{ref_script})",
        "set -euo pipefail",
        # literal paths are shell-quoted (spaces/metachars under set -u
        # would otherwise split the assignment); $VAR forms stay unquoted
        # so the environment expands them
        f"JPG_ROOT=${{JPG_ROOT:-{jpg_root}}}" if jpg_root.startswith("$")
        else f"JPG_ROOT={shlex.quote(jpg_root)}",
        f"SAVEDIR=${{SAVEDIR:-{savedir}}}" if savedir.startswith("$")
        else f"SAVEDIR={shlex.quote(savedir)}",
        f"INIT={init_checkpoint_path}" if init_checkpoint_path.startswith("$")
        else f"INIT={shlex.quote(init_checkpoint_path)}",
    ]
    if needs_control_root:
        # env-overridable with the passed value (or empty) as the default
        ctl = (control_data_root
               if control_data_root.startswith("$") or not control_data_root
               else shlex.quote(control_data_root))
        lines.append(f"CONTROL_ROOT=${{CONTROL_ROOT:-{ctl}}}")
    lines.append("")
    # condition must reach build_stage_config so the Matched* frame
    # overrides land in the emitted flags exactly as in a live run
    base = TrainConfig()
    base.data.condition = condition
    for info in plan:
        cfg = build_stage_config(preset, info, base)
        o, d, m = cfg.optim, cfg.data, cfg.model
        cmd = [
            f"{launch} bvc_tpu_torch.cli.{cli}{mesh_flag}{shard_flag}",
            f'-train_group {info["train_group"]} -jpg_root "$JPG_ROOT" '
            f'-savedir "$SAVEDIR" -init_checkpoint_path "$INIT"',
            f'--run_id {info["run_id"]} --fold {info["fold"]} '
            f"--seed {seed} --condition {condition}",
            f"--n_epoch {cfg.n_epoch} --max_epoch_iters {cfg.max_epoch_iters} "
            f"--batch_size {d.batch_size} --n_trainsamples {d.n_trainsamples}",
            f"--optim {o.name} --lr {o.lr} --momentum {o.momentum} --wd {o.weight_decay}",
        ]
        if preset.family == "videomae":
            cmd.append(f"--mask_sampler {cfg.mask.sampler} "
                       f"--mask_ratio {cfg.mask.mask_ratio} "
                       f"--num_frames {d.num_frames} "
                       f"--tubelet_size {d.tubelet_size}")
            if needs_control_root:
                # pickled control seqlists (data/factory.py
                # CONTROL_CONDITIONS); the header defaults $CONTROL_ROOT
                # to the value passed at emit time
                cmd.append('--control_data_root "$CONTROL_ROOT"')
        elif preset.family == "jepa":
            cmd.append(f"--enc_mask_scale {cfg.mask.enc_mask_scale[0]} "
                       f"--pred_mask_scale {cfg.mask.pred_mask_scale[0]} "
                       f"--interval {d.interval} --augs {d.augs} "
                       f"--architecture {preset.architecture.removeprefix('vit_')}")
        else:
            cmd.append(f"--pred_emb_dim {m.pred_emb_dim} "
                       f"--interval {d.interval} --augs {d.augs} "
                       f"--architecture {m.architecture}")
        lines.append(f"# stage {info['stage']}: group {info['train_group']}")
        lines.append(" \\\n  ".join(cmd))
        lines.append(f'INIT="$SAVEDIR/model_{info["run_id"]}.pth.tar"')
        lines.append("")
    # extraction must build the model at the TRAINED dims — the Matched*
    # conditions override num_frames/tubelet, so use the stage config's
    # model (what the live _run_extraction does via model_cfg)
    m_ex = build_stage_config(preset, plan[0], base).model
    for task, vid_root in (extract or {}).items():
        # user-supplied path: quote like the header assignments ($VAR
        # forms stay expandable)
        vr = vid_root if vid_root.startswith("$") else shlex.quote(vid_root)
        lines.append(
            f"{launch} bvc_tpu_torch.cli.compute_embeddings{mesh_flag} -ds_task {task} "
            f'-vid_root {vr} -savedir "$SAVEDIR/benchmarks/{task}" '
            f'--family {preset.family} --checkpoint_dir "$SAVEDIR" '
            f"--num_frames {m_ex.num_frames} "
            f"--tubelet_size {m_ex.tubelet_size} "
            f"--architecture {m_ex.architecture} "
            f"--frame_rate {frame_rate} --batch_size {extract_batch_size} "
            f"--seed {seed}"
            + (f" --quantize {extract_quantize}"
               if extract_quantize != "none" else "")
        )
    return "\n".join(lines) + "\n"


def _trainer_for(family: str):
    if family == "videomae":
        from bvc_tpu_torch.training.trainer_videomae import run_pretraining
    elif family == "jepa":
        from bvc_tpu_torch.training.trainer_jepa import run_pretraining
    elif family == "simclr":
        from bvc_tpu_torch.training.trainer_simclr import run_pretraining
    else:
        raise ValueError(family)
    return run_pretraining


def _run_extraction(
    task: dict[str, Any],
    checkpoints: list[str],
    run_ids: list[str],
    model_cfg,
    family: str,
    base: TrainConfig,
    device: torch.device,
    logger,
) -> list[dict[str, Any]]:
    """Extract embeddings for every (checkpoint, run_id) over one task on
    ``device``, data parallel under a process group (rank 0 writes the
    CSVs; the entries name the paths on every rank).

    ``checkpoints[i] == 'na'`` uses an untrained model (the bash stage-0
    baseline, ``slurm_dev_def.bash:68-87``).
    """
    from bvc_tpu_torch.evalbench.extract import (
        extract_embeddings,
        make_embed_fn,
        make_task_dataset,
        save_results,
        untrained_embed_fn,
    )

    savedir = task.get(
        "savedir", str(Path(base.savedir) / "benchmarks" / task["ds_task"])
    )
    quantize = task.get("quantize", "none")  # opt-in W8A8 (ops/quant.py)
    outs = []
    for ckpt, run_id in zip(checkpoints, run_ids):
        if ckpt == "na":
            fn = untrained_embed_fn(family, model_cfg, base.seed, device=device,
                                    quantize=quantize, mesh_shape=base.mesh_shape)
        else:
            fn = make_embed_fn(family, ckpt, model_cfg, device=device,
                               quantize=quantize, mesh_shape=base.mesh_shape)
        for phase in ("train", "test"):
            ds = make_task_dataset(
                task["ds_task"], task["vid_root"],
                task.get("frame_rate", 12), model_cfg.num_frames,
                train=(phase == "train"),
                image_size=model_cfg.image_size,
                annotation_path=task.get("annotation_path", ""),
            )
            names, embs = extract_embeddings(
                fn, ds, task.get("batch_size", 64), base.data.num_workers,
            )
            path = str(Path(savedir) / ("test" if phase == "test" else "")
                       / f"embeddings_{run_id}.csv")
            if is_main_process():
                path = save_results(names, embs, phase, run_id, savedir)
            logger.info("extraction: %s %s -> %s", task["ds_task"], phase, path)
            outs.append({"ds_task": task["ds_task"], "phase": phase,
                         "run_id": run_id, "csv": path})
    return outs


def run_curriculum(
    curriculum: str,
    preset: "str | FamilyPreset",
    base: TrainConfig,
    n_stages: int = 3,
    condition: str = "default",
    init_checkpoint_path: str = "na",
    extraction: list[dict[str, Any]] | None = None,
    untrained_baseline: bool = False,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Run all stages on ``device`` (``cuda`` when None; raises when there is
    none; the rank's GPU under a process group, data parallel over
    ``base.mesh_shape``); returns {stage → summary} + checkpoint chain.

    ``preset`` may be a registry name or a FamilyPreset instance (e.g.
    from ``apply_overrides``).

    ``extraction``: optional benchmark extraction specs (dicts with
    ``ds_task``, ``vid_root`` and optional ``frame_rate``/``batch_size``/
    ``savedir``/``annotation_path``) — the bash scripts' final
    ``--checkpoint_dir`` sweep (``slurm_dev_def.bash:165-177``) over every
    stage checkpoint.  ``untrained_baseline`` additionally runs the
    stage-0 extraction from random init with run-id
    ``{curr}_0_na_{condition}_0_{seed}`` (``:68-87``).
    """
    logger = get_logger("bvc_tpu_torch.curriculum")
    if isinstance(preset, str):
        preset = FAMILY_PRESETS[preset]
    # before any stage trains: a layout the mesh cannot take would reach the
    # trainers (which refuse it) only after the untrained baseline ran
    run_mesh(base, preset.family)
    device = resolve_device(device)
    base = copy.deepcopy(base)
    base.data.condition = condition
    plan = stage_plan(curriculum, preset, base.seed, condition, n_stages)
    trainer = _trainer_for(preset.family)
    model_cfg = build_stage_config(preset, plan[0], base).model

    results: dict[str, Any] = {"curriculum": curriculum, "stages": []}
    if untrained_baseline and extraction:
        rid0 = str(RunId(curriculum, 0, "na", condition, 0, base.seed))
        for task in extraction:
            results.setdefault("extraction", []).extend(
                _run_extraction(task, ["na"], [rid0], model_cfg,
                                preset.family, base, device, logger)
            )

    ckpt = init_checkpoint_path
    for info in plan:
        cfg = build_stage_config(preset, info, base)
        cfg.init_checkpoint_path = ckpt
        logger.info("=== stage %d: group=%s fold=%d run_id=%s (init=%s)",
                    info["stage"], info["train_group"], info["fold"],
                    info["run_id"], ckpt)
        summary = trainer(cfg, device=device)
        ckpt = summary["checkpoint"]
        results["stages"].append({**info, **summary})
    results["final_checkpoint"] = ckpt

    if extraction:
        ckpts = [s["checkpoint"] for s in results["stages"]]
        rids = [s["run_id"] for s in results["stages"]]
        for task in extraction:
            results.setdefault("extraction", []).extend(
                _run_extraction(task, ckpts, rids, model_cfg,
                                preset.family, base, device, logger)
            )

    if is_main_process():
        manifest = Path(base.savedir) / f"curriculum_{curriculum}_{condition}_{base.seed}.json"
        manifest.parent.mkdir(parents=True, exist_ok=True)
        manifest.write_text(json.dumps(results, indent=2, default=str))
    return results
