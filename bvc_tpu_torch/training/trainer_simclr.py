"""SimCLR pretraining — one curriculum stage on one GPU or data parallel over
several (counterpart of :func:`bvc_tpu.training.trainer_simclr.run_pretraining`;
run by :mod:`~bvc_tpu_torch.training.stage`, with its ranks, negatives and
BatchNorm statistics per ``--negatives`` and ``--bn_stats``).

ResNet with the 2-layer MLP head, interleaved-pair InfoNCE at tau = 0.1
(hard-coded in the reference, ``pretrain_simclr.py:284``), the contrastive
CSV schema (epoch, itr, train loss, grad-conv1, grad-fc0, time (ms)),
``params_{run_id}.yaml`` and the checkpoint ``model_{run_id}.pth.tar``:
``model_state_dict`` in torchvision names with the BatchNorm running
statistics (:func:`~bvc_tpu_torch.models.convert.resnet_to_torchvision_state_dict`),
the export's ``train_loss`` and the stage's keys (``meta`` with
``architecture``).  Under ``--param_sharding tp`` the ResNet
matches no tensor-parallel rule: it stays whole on every ``model`` rank and
the batch is split over ``data`` only, as in the JAX package.
"""

from __future__ import annotations

import torch

from bvc_tpu_torch.data.factory import make_dataset
from bvc_tpu_torch.data.loader import DataLoader
from bvc_tpu_torch.models.convert import (resnet_from_torchvision_state_dict,
                                          resnet_to_torchvision_state_dict)
from bvc_tpu_torch.models.resnet import ResNet
from bvc_tpu_torch.training.checkpoint import load_checkpoint
from bvc_tpu_torch.training.metrics_pipe import MetricsPipe
from bvc_tpu_torch.training.optim import schedule_steps
from bvc_tpu_torch.training.probes import format_gstats, full_grad_probes
from bvc_tpu_torch.training.stage import Stage
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_simclr_train_step
from bvc_tpu_torch.utils.config import TrainConfig
from bvc_tpu_torch.utils.profiling import StepTraceWindow

TEMPERATURE = 0.1  # hard-coded in the reference (pretrain_simclr.py:284)
COLUMNS = (("%d", "epoch"), ("%d", "itr"), ("%.5f", "train loss"), ("%.4e", "grad-conv1"),
           ("%.4e", "grad-fc0"), ("%d", "time (ms)"))


def run_pretraining(cfg: TrainConfig, device: str | torch.device | None = None) -> dict:
    """Train one stage on ``device`` (``cuda`` when None; raises when there
    is none); returns a summary with the final loss and the checkpoint
    path."""
    stage = Stage(cfg, "simclr", device, COLUMNS, {"train_loss": "train"})
    if (done := stage.completed(cfg.n_epoch)) is not None:
        return done
    logger, world, device = stage.logger, stage.mesh.size, stage.device

    # model / optimizer / state ------------------------------------------------
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
    # resuming restores the weights with the running statistics
    start_epoch = stage.resume(state, lambda ckpt: state.load_model_state_dict(
        resnet_from_torchvision_state_dict(ckpt["model_state_dict"])))
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

    def row(epoch, phase, itr, metrics, ms):
        return (epoch + 1, itr, metrics["loss"], metrics["grad_conv1"], metrics["grad_fc0"],
                int(ms))

    def line(epoch, phase, itr, metrics, ms):
        return ("[%d, %5d] loss: %.3f (%.0f ms)%s", epoch + 1, itr, stage.mean(phase), ms,
                format_gstats(metrics))

    def checkpoint():
        return ({"model_state_dict": resnet_to_torchvision_state_dict(state.model_state_dict())},
                {"architecture": arch})

    return stage.run(state, step, {"train": loader}, range(start_epoch, cfg.n_epoch), row=row,
                     line=line, layout=checkpoint, metrics_pipe=MetricsPipe,
                     tracer=StepTraceWindow(cfg.profile_dir))
