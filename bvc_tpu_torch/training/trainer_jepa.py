"""(V-)JEPA pretraining — one curriculum stage on one GPU or data parallel
over several (counterpart of
:func:`bvc_tpu.training.trainer_jepa.run_pretraining`; ranks as in
:mod:`~bvc_tpu_torch.training.trainer_videomae`).

Multi-block mask collation in the input pipeline, the context encoder and
predictor, the EMA target encoder, the predictive CSV schema (epoch, itr,
loss, grad-FL, grad-LL, mask-A, mask-B, time (ms)), ``params_{run_id}.yaml``
and the checkpoint ``model_{run_id}.pth.tar`` in the reference's three-model
layout (``encoder``, ``predictor`` and ``target_encoder`` in the reference
ViT names, ``pretrain_jepa.py:126-142``, as ``bvc_tpu/cli/export_torch.py``
exports), plus ``opt``, ``epoch``, ``step``, ``rng``, the export's ``loss``,
``batch_size``, ``world_size`` and ``lr``, and ``meta`` (with the
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
from pathlib import Path

import numpy as np
import torch

from bvc_tpu_torch.data.factory import make_dataset
from bvc_tpu_torch.data.loader import DataLoader
from bvc_tpu_torch.masks.multiblock import MultiBlockMaskCollator, update_mask_indices
from bvc_tpu_torch.models.convert import (jepa_encoder_from_reference_state_dict,
                                          jepa_encoder_to_reference,
                                          jepa_predictor_from_reference_state_dict,
                                          jepa_predictor_to_reference)
from bvc_tpu_torch.models.jepa import JEPA
from bvc_tpu_torch.parallel.collectives import sync_hosts
from bvc_tpu_torch.parallel.mesh import data_rank, data_size
from bvc_tpu_torch.training.checkpoint import (checkpoint_exists, checkpoint_path,
                                               checkpoint_saver, load_checkpoint, load_meta,
                                               load_optimizer_state, optimizer_state_dict)
from bvc_tpu_torch.training.metrics_pipe import MetricsPipe
from bvc_tpu_torch.training.optim import schedule_steps
from bvc_tpu_torch.training.probes import format_gstats, full_grad_probes
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_jepa_train_step
from bvc_tpu_torch.training.trainer_videomae import refuse_unported
from bvc_tpu_torch.utils.config import TrainConfig
from bvc_tpu_torch.utils.device import resolve_device
from bvc_tpu_torch.utils.logging import AverageMeter, CSVLogger, get_logger, is_main_process
from bvc_tpu_torch.utils.profiling import StepTraceWindow


def make_mask_collate(cfg: TrainConfig, batches_per_epoch: int):
    """``(collate_fn, collator)``: ``collate_fn(batch, epoch, batch_idx)``
    attaches the enc/pred mask indices of collator step ``epoch *
    batches_per_epoch + batch_idx`` to each batch: this rank's rows of the
    indices drawn for the global batch of every data rank's block."""
    m = cfg.model
    collator = MultiBlockMaskCollator(
        input_size=m.image_size,
        patch_size=m.patch_size,
        enc_mask_scale=tuple(cfg.mask.enc_mask_scale),
        pred_mask_scale=tuple(cfg.mask.pred_mask_scale),
        aspect_ratio=tuple(cfg.mask.aspect_ratio),
        nenc=cfg.mask.num_enc_masks,
        npred=cfg.mask.num_pred_masks,
        min_keep=cfg.mask.min_keep,
        allow_overlap=cfg.mask.allow_overlap,
        seed=cfg.seed,
    )
    if cfg.mask.num_enc_masks != 1:
        raise NotImplementedError("nenc != 1 not supported (reference always uses 1)")

    def collate(batch: np.ndarray, epoch: int, batch_idx: int):
        step = epoch * batches_per_epoch + batch_idx
        b, r = batch.shape[0], data_rank()
        enc_idx, pred_idx = collator(b * data_size(), step=step)
        enc_idx, pred_idx = (x[:, r * b:(r + 1) * b] for x in (enc_idx, pred_idx))
        lift = (m.image_size, m.patch_size, m.num_frames, m.tubelet_size)
        enc_idx = update_mask_indices(enc_idx, *lift, isencoder=True)
        pred_idx = update_mask_indices(pred_idx, *lift, isencoder=False)
        return {
            "video": batch,
            "enc_idx": enc_idx[0],                       # nenc=1 → [B, Ke]
            "pred_idx": pred_idx.transpose(1, 0, 2),     # [B, M, Kp]
        }

    return collate, collator


def prefixed(prefix: str, sd: dict) -> dict:
    return {prefix + k: v for k, v in sd.items()}


def unprefixed(prefix: str, sd: dict) -> dict:
    """The entries of ``sd`` under ``prefix``, the prefix dropped."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def run_pretraining(cfg: TrainConfig, device: str | torch.device | None = None) -> dict:
    """Train one stage on ``device`` (``cuda`` when None; raises when there
    is none); returns a summary with the final loss and the checkpoint
    path."""
    logger = get_logger("bvc_tpu_torch.jepa")
    for axis in ("seq", "pipe"):
        if axis in cfg.mesh_shape:
            raise ValueError(
                f"'{axis}' parallelism is videomae-only (this family's "
                "clips fit one chip; the axis would replicate the whole "
                "step across it and inflate global_batch with no "
                "speedup) -- use a pure-data mesh")
    world = refuse_unported(cfg).size
    device = resolve_device(device)
    if not cfg.savedir:
        raise ValueError("savedir is required")
    folder = Path(cfg.savedir)
    folder.mkdir(parents=True, exist_ok=True)
    csv_logger = None
    if is_main_process():
        cfg.dump_yaml(folder / f"params_{cfg.run_id}.yaml")
        csv_logger = CSVLogger(
            str(folder / f"csvlog_{cfg.run_id}.csv"),
            ("%d", "epoch"), ("%d", "itr"), ("%.5f", "loss"),
            ("%.4e", "grad-FL"), ("%.4e", "grad-LL"),
            ("%d", "mask-A"), ("%d", "mask-B"), ("%d", "time (ms)"),
            append=cfg.resume,  # keep prior epochs' rows when resuming
        )

    # chain_start needs only the previous stage's epoch count: read it from
    # the meta, so the stage-skip path never loads the three models
    own_ckpt = checkpoint_path(folder, cfg.run_id)
    resuming = cfg.resume and checkpoint_exists(own_ckpt)
    chain_start = 0
    if cfg.init_checkpoint_path != "na":
        chain_start = int(load_meta(cfg.init_checkpoint_path).get("epoch", 0))
    if resuming:
        meta = load_meta(own_ckpt)
        if int(meta.get("epoch", -1)) >= chain_start + cfg.n_epoch:
            logger.info("run already complete (epoch %s/%d) — nothing to do",
                        meta.get("epoch"), chain_start + cfg.n_epoch)
            return {"checkpoint": str(own_ckpt), "train_loss": meta.get("loss", 0.0)}

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
        load_optimizer_state(state.optimizer, ckpt["opt"])

    start_epoch = chain_start
    if resuming:
        # mid-stage preemption recovery: the three models, the optimizer,
        # the epoch, the step (the EMA ramp) and the generator (drop-path);
        # the mask stream is (seed, epoch, batch)-deterministic
        logger.info("resuming from %s", own_ckpt)
        restored = load_checkpoint(own_ckpt)
        restore(restored)
        state.step = int(restored["step"])
        state.generator.set_state(restored["rng"])
        start_epoch = int(restored["epoch"])
    elif cfg.init_checkpoint_path != "na":
        # the reference loads enc/pred/target AND the optimizer when chaining
        # stages (pretrain_jepa.py:290-300); step and generator are not
        # adopted: each stage restarts its EMA ramp (:309-311)
        logger.info("init from checkpoint %s", cfg.init_checkpoint_path)
        restore(load_checkpoint(cfg.init_checkpoint_path))

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
    if len(loader) == 0:
        raise ValueError(
            f"dataset ({len(datasets['train'])} samples) is smaller than the "
            f"batch ({global_batch}); no training would happen")

    save_fn, save_wait = checkpoint_saver(cfg)
    loss_meter = AverageMeter()

    def save(epoch_done: int):
        sd = state.model_state_dict()
        save_fn(own_ckpt, {
            "encoder": jepa_encoder_to_reference(unprefixed("encoder.", sd), cfg.model),
            "predictor": jepa_predictor_to_reference(unprefixed("predictor.", sd), cfg.model),
            "target_encoder": jepa_encoder_to_reference(state.target_state_dict(), cfg.model),
            "opt": optimizer_state_dict(state.optimizer),
            "scaler": None,
            "epoch": epoch_done,
            "step": state.step,
            "rng": state.generator.get_state(),
            "loss": loss_meter.avg,
            "batch_size": cfg.data.batch_size, "world_size": world, "lr": cfg.optim.lr,
        }, meta={
            "run_id": cfg.run_id, "epoch": epoch_done, "loss": loss_meter.avg,
            "batch_size": cfg.data.batch_size, "world_size": world, "lr": cfg.optim.lr,
            "family": "jepa", "collator_step": collator.state_dict()["step"],
            "script": cfg.script,
        })
        sync_hosts()  # no rank reads it before rank 0 has written it

    tracer = StepTraceWindow(cfg.profile_dir)  # no-op when unset
    for epoch in range(start_epoch, chain_start + cfg.n_epoch):
        loss_meter = AverageMeter()
        mask_a, mask_b = AverageMeter(), AverageMeter()
        pipe_ms = [0.0]

        def log_fn(itr, metrics, epoch=epoch):
            loss = metrics["loss"]
            loss_meter.update(loss)
            mask_a.update(metrics["mask_a"])
            mask_b.update(metrics["mask_b"])
            if csv_logger is not None:
                csv_logger.log(epoch + 1, itr, loss, metrics["grad_fl"], metrics["grad_ll"],
                               int(metrics["mask_a"]), int(metrics["mask_b"]),
                               int(pipe_ms[0]))
            if itr % cfg.log_freq == 0:
                logger.info("[%d, %5d] loss: %.3f masks: %.1f %.1f (%.0f ms) m=%.4f%s",
                            epoch + 1, itr, loss_meter.avg, mask_a.avg, mask_b.avg,
                            pipe_ms[0], metrics["ema_m"], format_gstats(metrics))
            if loss != loss or abs(loss) == float("inf"):
                raise FloatingPointError(f"loss is {loss} at epoch {epoch} itr {itr}")

        pipe = MetricsPipe(log_fn, time_every=cfg.log_freq)
        for itr, batch in enumerate(loader.epoch(epoch)):
            tracer.step()
            metrics = step(state, batch)
            pipe_ms[0] = pipe.push(itr, metrics)
        pipe.flush()
        logger.info("epoch %d avg loss %.4f", epoch + 1, loss_meter.avg)
        if cfg.save_every_epoch and epoch + 1 < chain_start + cfg.n_epoch:
            save(epoch + 1)

    tracer.close()
    save(chain_start + cfg.n_epoch)
    save_wait()  # async: the returned path must be complete on disk
    logger.info("checkpoint saved at %s", own_ckpt)
    return {"checkpoint": str(own_ckpt), "train_loss": loss_meter.avg}
