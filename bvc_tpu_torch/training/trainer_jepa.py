"""(V-)JEPA pretraining — one curriculum stage on one GPU or data parallel
over several (counterpart of
:func:`bvc_tpu.training.trainer_jepa.run_pretraining`; run by
:mod:`~bvc_tpu_torch.training.stage`, with its ranks).

Multi-block mask collation in the input pipeline, the context encoder and
predictor, the EMA target encoder, the predictive CSV schema (epoch, itr,
loss, grad-FL, grad-LL, mask-A, mask-B, time (ms)), ``params_{run_id}.yaml``
and the checkpoint ``model_{run_id}.pth.tar`` in the reference's three-model
layout (``encoder``, ``predictor`` and ``target_encoder`` in the reference
ViT names, ``pretrain_jepa.py:126-142``, as ``bvc_tpu/cli/export_torch.py``
exports), the export's ``loss`` and the stage's keys (``meta`` with the
collator's ``collator_step``).

Over several ranks, the collator draws the masks of the whole global batch
on every rank and each rank keeps its ``data`` coordinate's rows: the
collator cuts every row to the smallest kept counts over the batch it
draws, so drawing a rank's rows alone would give other caps than one
process at the global batch.  The target encoder takes the online
encoder's layout under every ``--param_sharding``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from bvc_tpu_torch.data.factory import make_dataset
from bvc_tpu_torch.data.loader import DataLoader
from bvc_tpu_torch.masks.multiblock import mask_collate
from bvc_tpu_torch.masks.multiblock3d import mask_collate_3d
from bvc_tpu_torch.models.convert import (jepa_encoder_from_reference_state_dict,
                                          jepa_encoder_to_reference,
                                          jepa_predictor_from_reference_state_dict,
                                          jepa_predictor_to_reference)
from bvc_tpu_torch.models.jepa import JEPA
from bvc_tpu_torch.parallel.mesh import data_rank, data_size
from bvc_tpu_torch.training.checkpoint import load_checkpoint, load_meta, load_optimizer_state
from bvc_tpu_torch.training.metrics_pipe import MetricsPipe
from bvc_tpu_torch.training.optim import schedule_steps
from bvc_tpu_torch.training.probes import format_gstats, full_grad_probes
from bvc_tpu_torch.training.stage import Stage
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_jepa_train_step
from bvc_tpu_torch.utils.config import TrainConfig
from bvc_tpu_torch.utils.profiling import StepTraceWindow

COLUMNS = (("%d", "epoch"), ("%d", "itr"), ("%.5f", "loss"), ("%.4e", "grad-FL"),
           ("%.4e", "grad-LL"), ("%d", "mask-A"), ("%d", "mask-B"), ("%d", "time (ms)"))


def make_mask_collate(cfg: TrainConfig, batches_per_epoch: int):
    """``(collate_fn, collator)``: ``collate_fn(batch, epoch, batch_idx)``
    attaches the enc/pred mask indices of collator step ``epoch *
    batches_per_epoch + batch_idx`` to each batch: this rank's rows of the
    indices drawn for the global batch of every data rank's block
    (:func:`~bvc_tpu_torch.masks.multiblock.mask_collate`; with
    ``cfg.mask.sampler == 'multiblock3d'`` V-JEPA's 3-D masks,
    :func:`~bvc_tpu_torch.masks.multiblock3d.mask_collate_3d`)."""
    make = mask_collate_3d if cfg.mask.sampler == "multiblock3d" else mask_collate
    masks = make(cfg.model, cfg.mask, cfg.seed)

    def collate(batch: np.ndarray, epoch: int, batch_idx: int):
        b, r = batch.shape[0], data_rank()
        drawn = masks(b * data_size(), epoch * batches_per_epoch + batch_idx)
        return {"video": batch, **{k: v[r * b:(r + 1) * b] for k, v in drawn.items()}}

    return collate, masks.collator


def prefixed(prefix: str, sd: dict) -> dict:
    return {prefix + k: v for k, v in sd.items()}


def unprefixed(prefix: str, sd: dict) -> dict:
    """The entries of ``sd`` under ``prefix``, the prefix dropped."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def run_pretraining(cfg: TrainConfig, device: str | torch.device | None = None) -> dict:
    """Train one stage on ``device`` (``cuda`` when None; raises when there
    is none); returns a summary with the final loss and the checkpoint
    path."""
    stage = Stage(cfg, "jepa", device, COLUMNS, {"loss": "train"}, scaler=True)
    # chain_start needs only the previous stage's epoch count: read it from
    # the meta, so the stage-skip path never loads the three models
    chain_start = 0
    if cfg.init_checkpoint_path != "na":
        chain_start = int(load_meta(cfg.init_checkpoint_path).get("epoch", 0))
    if (done := stage.completed(chain_start + cfg.n_epoch)) is not None:
        return done
    logger, world, device = stage.logger, stage.mesh.size, stage.device

    # model / state ------------------------------------------------------------
    model = JEPA(cfg.model, seed=cfg.seed)
    state = TrainState.create(model, cfg.optim, seed=cfg.seed + 1, device=device,
                              steps=schedule_steps(cfg, world),
                              target=copy.deepcopy(model.encoder),
                              param_sharding=cfg.param_sharding)

    def restore(ckpt: dict) -> None:
        state.load_model_state_dict({
            **prefixed("encoder.", jepa_encoder_from_reference_state_dict(ckpt["encoder"],
                                                                          cfg.model)),
            **prefixed("predictor.", jepa_predictor_from_reference_state_dict(
                ckpt["predictor"], cfg.model))})
        state.load_target_state_dict(
            jepa_encoder_from_reference_state_dict(ckpt["target_encoder"], cfg.model))

    # resuming restores the three models, the optimizer, the epoch, the step
    # (the EMA ramp) and the generator (drop-path); the mask stream is (seed,
    # epoch, batch)-deterministic
    start_epoch = stage.resume(state, restore, chain_start)
    if not stage.resuming and cfg.init_checkpoint_path != "na":
        # the reference loads enc/pred/target AND the optimizer when chaining
        # stages (pretrain_jepa.py:290-300); step and generator are not
        # adopted: each stage restarts its EMA ramp (:309-311)
        logger.info("init from checkpoint %s", cfg.init_checkpoint_path)
        init = load_checkpoint(cfg.init_checkpoint_path)
        restore(init)
        load_optimizer_state(state.optimizer, init["opt"])

    # data ---------------------------------------------------------------------
    datasets = make_dataset("jepa", cfg.data)
    global_batch = cfg.data.batch_size * world
    n_batches = len(datasets["train"]) // global_batch
    if cfg.max_epoch_iters:
        n_batches = min(n_batches, cfg.max_epoch_iters)
    collate, collator = make_mask_collate(cfg, n_batches)
    # the EMA momentum ramps over the real iteration count (reference
    # pretrain_jepa.py:309-311 uses ipe*num_epochs)
    total_steps = max(n_batches, 1) * cfg.n_epoch
    step = make_jepa_train_step(
        cfg.model, total_steps, cfg.optim.ema, cfg.optim.ema_fallback,
        grad_accum=cfg.optim.grad_accum_steps,
        grad_probes=full_grad_probes("jepa") if cfg.log_grad_stats else None)
    loader = DataLoader(
        datasets["train"], global_batch, shuffle=True, seed=cfg.seed,
        num_workers=cfg.data.num_workers, prefetch=cfg.data.prefetch,
        max_batches=cfg.max_epoch_iters, collate_fn=collate, device=device,
    )
    logger.info("dataset: %d samples, %d iters/epoch, global batch %d over %d ranks, on %s",
                len(datasets["train"]), len(loader), global_batch, world, device)

    def row(epoch, phase, itr, metrics, ms):
        return (epoch + 1, itr, metrics["loss"], metrics["grad_fl"], metrics["grad_ll"],
                int(metrics["mask_a"]), int(metrics["mask_b"]), int(ms))

    def line(epoch, phase, itr, metrics, ms):
        return ("[%d, %5d] loss: %.3f masks: %.1f %.1f (%.0f ms) m=%.4f%s", epoch + 1, itr,
                stage.mean(phase), stage.mean(phase, "mask_a"), stage.mean(phase, "mask_b"),
                ms, metrics["ema_m"], format_gstats(metrics))

    def checkpoint():
        sd = state.model_state_dict()
        return {
            "encoder": jepa_encoder_to_reference(unprefixed("encoder.", sd), cfg.model),
            "predictor": jepa_predictor_to_reference(unprefixed("predictor.", sd), cfg.model),
            "target_encoder": jepa_encoder_to_reference(state.target_state_dict(), cfg.model),
        }, {"collator_step": collator.state_dict()["step"]}

    return stage.run(state, step, {"train": loader}, range(start_epoch, chain_start + cfg.n_epoch),
                     row=row, line=line, layout=checkpoint, metrics_pipe=MetricsPipe,
                     tracer=StepTraceWindow(cfg.profile_dir))
