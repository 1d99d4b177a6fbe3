"""VideoMAE pretraining — one curriculum stage on one GPU
(counterpart of :func:`bvc_tpu.training.trainer_videomae.run_pretraining`,
its data-parallel branch).

Artifacts, as the JAX trainer writes them: ``csvlog_{run_id}.csv`` (epoch,
itr, train loss, val loss, grad-EFL, grad-ELL, grad-DLL),
``params_{run_id}.yaml`` and the checkpoint ``model_{run_id}.pth.tar``:
``model_state_dict`` in HF ``VideoMAEForPreTraining`` names (encoder and
decoder, as ``bvc_tpu/cli/export_torch.py`` exports), ``qkv_k_bias`` (the k
thirds of the qkv biases, which HF's layout drops), ``opt``, ``epoch``,
``step``, ``rng`` (the mask generator's state), the export's ``train_loss``,
``val_loss``, ``batch_size``, ``world_size`` and ``lr``, and ``meta``.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from bvc_tpu_torch.data.factory import make_dataset
from bvc_tpu_torch.data.loader import DataLoader
from bvc_tpu_torch.models.convert import (qkv_key_biases,
                                          videomae_pretrain_from_hf_state_dict,
                                          videomae_pretrain_to_hf_state_dict,
                                          with_qkv_key_biases)
from bvc_tpu_torch.models.videomae import VideoMAEPretrain
from bvc_tpu_torch.training.checkpoint import (checkpoint_exists, checkpoint_path,
                                               checkpoint_saver, load_checkpoint, load_meta,
                                               load_optimizer_state)
from bvc_tpu_torch.training.metrics_pipe import MetricsPipe
from bvc_tpu_torch.training.optim import schedule_steps
from bvc_tpu_torch.training.probes import format_gstats, full_grad_probes
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_videomae_train_step
from bvc_tpu_torch.utils.config import ModelConfig, TrainConfig
from bvc_tpu_torch.utils.device import resolve_device
from bvc_tpu_torch.utils.logging import AverageMeter, CSVLogger, get_logger, is_main_process
from bvc_tpu_torch.utils.profiling import StepTraceWindow, device_memory_stats


def refuse_unported(cfg: TrainConfig) -> None:
    """Raise for what the single-GPU trainers do not do yet: a mesh, a
    parameter sharding, several processes (the multi-GPU slice)."""
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if cfg.mesh_shape or cfg.param_sharding != "replicated" or world > 1:
        raise NotImplementedError(
            f"mesh {cfg.mesh_shape or '{}'}, param_sharding {cfg.param_sharding!r}, "
            f"WORLD_SIZE {world}: multi-GPU training comes with ROADMAP slice 7; "
            "this trainer runs on one GPU (empty --mesh, 'replicated')")


def videomae_model_state(ckpt: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """A checkpoint's ``model_state_dict`` (HF names) as the pretraining
    model's state dict, with its ``qkv_k_bias`` entries where it has them."""
    sd = videomae_pretrain_from_hf_state_dict(ckpt["model_state_dict"], cfg)
    return with_qkv_key_biases(sd, ckpt.get("qkv_k_bias", {}))


def run_pretraining(cfg: TrainConfig, device: str | torch.device | None = None) -> dict:
    """Train one stage on ``device`` (``cuda`` when None; raises when there
    is none); returns a summary with the final losses and the checkpoint
    path."""
    logger = get_logger("bvc_tpu_torch.videomae")
    refuse_unported(cfg)
    device = resolve_device(device)
    if not cfg.savedir:
        raise ValueError("savedir is required")
    folder = Path(cfg.savedir)
    folder.mkdir(parents=True, exist_ok=True)
    cfg.dump_yaml(folder / f"params_{cfg.run_id}.yaml")
    csv_logger = None
    if is_main_process():
        csv_logger = CSVLogger(
            str(folder / f"csvlog_{cfg.run_id}.csv"),
            ("%d", "epoch"), ("%d", "itr"),
            ("%.5f", "train loss"), ("%.5f", "val loss"),
            ("%.4e", "grad-EFL"), ("%.4e", "grad-ELL"), ("%.4e", "grad-DLL"),
            append=cfg.resume,  # keep prior epochs' rows when resuming
        )

    # model / optimizer / state ------------------------------------------------
    own_ckpt = checkpoint_path(folder, cfg.run_id)
    if cfg.resume and checkpoint_exists(own_ckpt):
        # completed-stage fast path: the meta answers the skip question
        # without reading the model and optimizer
        meta = load_meta(own_ckpt)
        if int(meta.get("epoch", -1)) >= cfg.n_epoch:
            logger.info("run already complete (epoch %s/%d) — nothing to do",
                        meta.get("epoch"), cfg.n_epoch)
            return {"checkpoint": str(own_ckpt), "train_loss": meta.get("train_loss", 0.0),
                    "val_loss": meta.get("val_loss", 0.0)}
    model = VideoMAEPretrain(cfg.model, seed=cfg.seed)
    if cfg.init_checkpoint_path != "na":
        logger.info("init from checkpoint %s", cfg.init_checkpoint_path)
        model.load_state_dict(videomae_model_state(load_checkpoint(cfg.init_checkpoint_path),
                                                   cfg.model))
    state = TrainState.create(model, cfg.optim, seed=cfg.seed + 1, device=device,
                              steps=schedule_steps(cfg))
    start_epoch = 0
    if cfg.resume and checkpoint_exists(own_ckpt):
        # mid-stage preemption recovery: weights, optimizer, epoch and
        # step/generator (so the mask stream continues, not replays)
        logger.info("resuming from %s", own_ckpt)
        restored = load_checkpoint(own_ckpt)
        state.model.load_state_dict(videomae_model_state(restored, cfg.model))
        load_optimizer_state(state.optimizer, restored["opt"])
        state.step = int(restored["step"])
        state.generator.set_state(restored["rng"])
        start_epoch = int(restored["epoch"])
    step = make_videomae_train_step(
        cfg.model, cfg.mask, grad_accum=cfg.optim.grad_accum_steps,
        grad_probes=full_grad_probes("videomae") if cfg.log_grad_stats else None)

    # data ---------------------------------------------------------------------
    datasets = make_dataset("videomae", cfg.data)
    global_batch = cfg.data.batch_size
    loaders = {
        phase: DataLoader(
            ds, global_batch, shuffle=(phase == "train"), seed=cfg.seed,
            num_workers=cfg.data.num_workers, prefetch=cfg.data.prefetch,
            max_batches=cfg.max_epoch_iters,
            # val keeps every sample by padding the last batch
            drop_last=(phase == "train"), device=device,
        )
        for phase, ds in datasets.items()
        if ds is not None
    }
    logger.info("datasets: train=%d val=%s, batch %d, %d iters/epoch, on %s",
                len(datasets["train"]), len(datasets["val"]) if datasets.get("val") else 0,
                global_batch, len(loaders["train"]), device)
    if len(loaders["train"]) == 0:
        raise ValueError(
            f"dataset ({len(datasets['train'])} samples) is smaller than the "
            f"batch ({global_batch}); no training would happen")

    save_fn, save_wait = checkpoint_saver(cfg)
    loss_meter: dict[str, AverageMeter] = {}

    def save(epoch_done: int):
        train_loss = loss_meter.get("train", AverageMeter()).avg
        val_loss = loss_meter.get("val", AverageMeter()).avg
        model_sd = state.model.state_dict()
        save_fn(own_ckpt, {
            "model_state_dict": videomae_pretrain_to_hf_state_dict(model_sd, cfg.model),
            "qkv_k_bias": qkv_key_biases(model_sd),
            "opt": state.optimizer.state_dict(),
            "epoch": epoch_done,
            "step": state.step,
            "rng": state.generator.get_state(),
            "train_loss": train_loss, "val_loss": val_loss,
            "batch_size": cfg.data.batch_size, "world_size": 1, "lr": cfg.optim.lr,
        }, meta={
            "run_id": cfg.run_id, "epoch": epoch_done,
            "train_loss": train_loss, "val_loss": val_loss,
            "batch_size": cfg.data.batch_size, "world_size": 1, "lr": cfg.optim.lr,
            "family": "videomae", "script": cfg.script,
        })

    tracer = StepTraceWindow(cfg.profile_dir)  # no-op when unset
    for epoch in range(start_epoch, cfg.n_epoch):
        loss_meter = {p: AverageMeter() for p in ("train", "val")}
        for phase, loader in loaders.items():
            pipe_ms = [0.0]

            def log_fn(itr, metrics, phase=phase, epoch=epoch):
                loss = metrics["loss"]
                loss_meter[phase].update(loss)
                train = phase == "train"
                if csv_logger is not None:
                    csv_logger.log(
                        epoch + 1, itr, loss if train else 0.0, 0.0 if train else loss,
                        *(metrics.get(k, 0.0) if train else 0.0
                          for k in ("grad_efl", "grad_ell", "grad_dll")))
                if itr % cfg.log_freq == 0:
                    mem = device_memory_stats(device)["peak_bytes_in_use"] / 1024**2
                    logger.info("[%d, %5d] %s loss: %.3f [mem: %.2e MB] (%.0f ms/it)%s",
                                epoch + 1, itr, phase, loss_meter[phase].avg, mem, pipe_ms[0],
                                format_gstats(metrics))
                if loss != loss or abs(loss) == float("inf"):
                    raise FloatingPointError(f"loss is {loss} at epoch {epoch} itr {itr}")

            # lag-1 logging: step i's row is written while step i+1 runs
            pipe = MetricsPipe(log_fn, time_every=cfg.log_freq)
            for itr, batch in enumerate(loader.epoch(epoch)):
                if phase == "train":
                    tracer.step()
                    metrics = step(state, batch)
                else:
                    metrics = step.eval_step(state, batch, itr)
                pipe_ms[0] = pipe.push(itr, metrics)
            pipe.flush()
            logger.info("epoch %d %s avg loss %.4f", epoch + 1, phase, loss_meter[phase].avg)
        if cfg.save_every_epoch and epoch + 1 < cfg.n_epoch:
            save(epoch + 1)

    tracer.close()
    save(cfg.n_epoch)
    save_wait()  # async: the returned path must be complete on disk
    logger.info("checkpoint saved at %s", own_ckpt)
    return {"checkpoint": str(own_ckpt),
            "train_loss": loss_meter.get("train", AverageMeter()).avg,
            "val_loss": loss_meter.get("val", AverageMeter()).avg}
