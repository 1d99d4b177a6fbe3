"""SimCLR pretraining — one curriculum stage on one GPU or data parallel over
several (counterpart of :func:`bvc_tpu.training.trainer_simclr.run_pretraining`;
ranks as in :mod:`~bvc_tpu_torch.training.trainer_videomae`, negatives and
BatchNorm statistics per ``--negatives`` and ``--bn_stats``).

ResNet with the 2-layer MLP head, interleaved-pair InfoNCE at tau = 0.1
(hard-coded in the reference, ``pretrain_simclr.py:284``), the contrastive
CSV schema (epoch, itr, train loss, grad-conv1, grad-fc0, time (ms)),
``params_{run_id}.yaml`` and the checkpoint ``model_{run_id}.pth.tar``:
``model_state_dict`` in torchvision names with the BatchNorm running
statistics (:func:`~bvc_tpu_torch.models.convert.resnet_to_torchvision_state_dict`),
``opt``, ``epoch``, ``step``, ``rng``, the export's ``train_loss``,
``batch_size``, ``world_size`` and ``lr``, and ``meta`` (``family:
simclr``, ``architecture``).  Under ``--param_sharding tp`` the ResNet
matches no tensor-parallel rule: it stays whole on every ``model`` rank and
the batch is split over ``data`` only, as in the JAX package.
"""

from __future__ import annotations

from pathlib import Path

import torch

from bvc_tpu_torch.data.factory import make_dataset
from bvc_tpu_torch.data.loader import DataLoader
from bvc_tpu_torch.models.convert import (resnet_from_torchvision_state_dict,
                                          resnet_to_torchvision_state_dict)
from bvc_tpu_torch.models.resnet import ResNet
from bvc_tpu_torch.parallel.collectives import sync_hosts
from bvc_tpu_torch.training.checkpoint import (checkpoint_exists, checkpoint_path,
                                               checkpoint_saver, load_checkpoint, load_meta,
                                               load_optimizer_state, optimizer_state_dict)
from bvc_tpu_torch.training.metrics_pipe import MetricsPipe
from bvc_tpu_torch.training.optim import schedule_steps
from bvc_tpu_torch.training.probes import format_gstats, full_grad_probes
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_simclr_train_step
from bvc_tpu_torch.training.trainer_videomae import refuse_unported
from bvc_tpu_torch.utils.config import TrainConfig
from bvc_tpu_torch.utils.device import resolve_device
from bvc_tpu_torch.utils.logging import AverageMeter, CSVLogger, get_logger, is_main_process
from bvc_tpu_torch.utils.profiling import StepTraceWindow

TEMPERATURE = 0.1  # hard-coded in the reference (pretrain_simclr.py:284)


def run_pretraining(cfg: TrainConfig, device: str | torch.device | None = None) -> dict:
    """Train one stage on ``device`` (``cuda`` when None; raises when there
    is none); returns a summary with the final loss and the checkpoint
    path."""
    logger = get_logger("bvc_tpu_torch.simclr")
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
            ("%d", "epoch"), ("%d", "itr"), ("%.5f", "train loss"),
            ("%.4e", "grad-conv1"), ("%.4e", "grad-fc0"), ("%d", "time (ms)"),
            append=cfg.resume,  # keep prior epochs' rows when resuming
        )

    # model / optimizer / state ------------------------------------------------
    own_ckpt = checkpoint_path(folder, cfg.run_id)
    resuming = cfg.resume and checkpoint_exists(own_ckpt)
    if resuming:
        # completed-stage fast path: the meta answers the skip question
        # without reading the model and optimizer
        meta = load_meta(own_ckpt)
        if int(meta.get("epoch", -1)) >= cfg.n_epoch:
            logger.info("run already complete (epoch %s/%d) — nothing to do",
                        meta.get("epoch"), cfg.n_epoch)
            return {"checkpoint": str(own_ckpt), "train_loss": meta.get("train_loss", 0.0)}
    arch = cfg.model.architecture or "resnet18"
    model = ResNet(arch, cfg.model.pred_emb_dim, dtype=cfg.model.dtype, seed=cfg.seed)
    if cfg.init_checkpoint_path != "na":
        # weights and BatchNorm running statistics; the optimizer starts anew
        logger.info("init from checkpoint %s", cfg.init_checkpoint_path)
        model.load_state_dict(resnet_from_torchvision_state_dict(
            load_checkpoint(cfg.init_checkpoint_path)["model_state_dict"]))
    state = TrainState.create(model, cfg.optim, seed=cfg.seed + 1, device=device,
                              steps=schedule_steps(cfg, world),
                              param_sharding=cfg.param_sharding)
    start_epoch = 0
    if resuming:
        # mid-stage preemption recovery: weights with the running
        # statistics, optimizer, epoch, step and generator
        logger.info("resuming from %s", own_ckpt)
        restored = load_checkpoint(own_ckpt)
        state.load_model_state_dict(resnet_from_torchvision_state_dict(
            restored["model_state_dict"]))
        load_optimizer_state(state.optimizer, restored["opt"])
        state.step = int(restored["step"])
        state.generator.set_state(restored["rng"])
        start_epoch = int(restored["epoch"])
    step = make_simclr_train_step(
        TEMPERATURE, loss_mode="parity", negatives=cfg.optim.contrastive_negatives,
        bn_stats=cfg.optim.bn_stats,
        grad_probes=full_grad_probes("simclr") if cfg.log_grad_stats else None,
        grad_accum=cfg.optim.grad_accum_steps)

    # data ---------------------------------------------------------------------
    datasets = make_dataset("simclr", cfg.data)
    global_batch = cfg.data.batch_size * world
    loader = DataLoader(
        datasets["train"], global_batch, shuffle=True, seed=cfg.seed,
        num_workers=cfg.data.num_workers, prefetch=cfg.data.prefetch,
        max_batches=cfg.max_epoch_iters, device=device,
    )
    logger.info("dataset: %d pairs, %d iters/epoch, global batch %d over %d ranks, on %s",
                len(datasets["train"]), len(loader), global_batch, world, device)
    if len(loader) == 0:
        raise ValueError(
            f"dataset ({len(datasets['train'])} samples) is smaller than the "
            f"batch ({global_batch}); no training would happen")

    save_fn, save_wait = checkpoint_saver(cfg)
    loss_meter = AverageMeter()

    def save(epoch_done: int):
        save_fn(own_ckpt, {
            "model_state_dict": resnet_to_torchvision_state_dict(state.model_state_dict()),
            "opt": optimizer_state_dict(state.optimizer),
            "epoch": epoch_done,
            "step": state.step,
            "rng": state.generator.get_state(),
            "train_loss": loss_meter.avg,
            "batch_size": cfg.data.batch_size, "world_size": world, "lr": cfg.optim.lr,
        }, meta={
            "run_id": cfg.run_id, "epoch": epoch_done, "train_loss": loss_meter.avg,
            "batch_size": cfg.data.batch_size, "world_size": world, "lr": cfg.optim.lr,
            "family": "simclr", "architecture": arch, "script": cfg.script,
        })
        sync_hosts()  # no rank reads it before rank 0 has written it

    tracer = StepTraceWindow(cfg.profile_dir)  # no-op when unset
    for epoch in range(start_epoch, cfg.n_epoch):
        loss_meter = AverageMeter()
        pipe_ms = [0.0]

        def log_fn(itr, metrics, epoch=epoch):
            loss = metrics["loss"]
            loss_meter.update(loss)
            if csv_logger is not None:
                csv_logger.log(epoch + 1, itr, loss, metrics["grad_conv1"], metrics["grad_fc0"],
                               int(pipe_ms[0]))
            if itr % cfg.log_freq == 0:
                logger.info("[%d, %5d] loss: %.3f (%.0f ms)%s", epoch + 1, itr,
                            loss_meter.avg, pipe_ms[0], format_gstats(metrics))
            if loss != loss or abs(loss) == float("inf"):
                raise FloatingPointError(f"loss is {loss} at epoch {epoch} itr {itr}")

        # lag-1 logging: step i's row is written while step i+1 runs
        pipe = MetricsPipe(log_fn, time_every=cfg.log_freq)
        for itr, batch in enumerate(loader.epoch(epoch)):
            tracer.step()
            metrics = step(state, batch)
            pipe_ms[0] = pipe.push(itr, metrics)
        pipe.flush()
        logger.info("epoch %d avg loss %.4f", epoch + 1, loss_meter.avg)
        if cfg.save_every_epoch and epoch + 1 < cfg.n_epoch:
            save(epoch + 1)

    tracer.close()
    save(cfg.n_epoch)
    save_wait()  # async: the returned path must be complete on disk
    logger.info("checkpoint saved at %s", own_ckpt)
    return {"checkpoint": str(own_ckpt), "train_loss": loss_meter.avg}
