"""VideoMAE pretraining — one curriculum stage on one GPU or data parallel
over several (counterpart of
:func:`bvc_tpu.training.trainer_videomae.run_pretraining`, its
data-parallel branch).

Artifacts, as the JAX trainer writes them: ``csvlog_{run_id}.csv`` (epoch,
itr, train loss, val loss, grad-EFL, grad-ELL, grad-DLL),
``params_{run_id}.yaml`` and the checkpoint ``model_{run_id}.pth.tar``:
``model_state_dict`` in HF ``VideoMAEForPreTraining`` names (encoder and
decoder, as ``bvc_tpu/cli/export_torch.py`` exports), ``qkv_k_bias`` (the k
thirds of the qkv biases, which HF's layout drops), ``opt``, ``epoch``,
``step``, ``rng`` (the mask generator's state), the export's ``train_loss``,
``val_loss``, ``batch_size``, ``world_size`` and ``lr``, and ``meta``.

Under a process group (torchrun, :func:`bvc_tpu_torch.parallel.distributed_init`)
the trainers run over the mesh of ``cfg.mesh_shape`` (``data``, or ``data``
and ``model``) with the parameters laid out by ``cfg.param_sharding``
(:class:`~bvc_tpu_torch.training.state.TrainState`): the global batch is
``batch_size * world`` (the flag is per GPU, as the JAX CLIs' per-device
flag), each rank loads its ``data`` coordinate's block of it.  VideoMAE also
runs on a mesh with ``seq`` (``data=D,seq=S[,model=M]``,
:mod:`bvc_tpu_torch.parallel.seqpar`): the global batch is ``batch_size *
D``, every rank of a ring loads its data block and keeps its time slice of
each clip, and the step splits the attention over the ring; and on a mesh
with ``pipe`` (``data=D,pipe=P``, :mod:`bvc_tpu_torch.parallel.pipeline`):
the global batch is ``batch_size * D``, every stage of a data row loads
the same block, and the GPipe step runs ``cfg.pipe_microbatches``
microbatches through the stages.  The steps
reduce the gradients and average the metrics over the data ranks, and rank
0 alone writes the CSV, ``params_{run_id}.yaml``, the checkpoints
(synchronously: the async writer waits at world > 1) and the profiler
trace, with a barrier after each checkpoint write.  A checkpoint holds whole
tensors in the same layout under every mode, so a stage resumes or chains
under any other.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import torch

from bvc_tpu_torch.data.factory import make_dataset
from bvc_tpu_torch.data.loader import DataLoader
from bvc_tpu_torch.models.convert import (qkv_key_biases,
                                          videomae_pretrain_from_hf_state_dict,
                                          videomae_pretrain_to_hf_state_dict,
                                          with_qkv_key_biases)
from bvc_tpu_torch.models.videomae import VideoMAEPretrain
from bvc_tpu_torch.parallel.collectives import sync_hosts
from bvc_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, Mesh,
                                         make_mesh)
from bvc_tpu_torch.parallel.pipeline import make_pipe_videomae_train_step
from bvc_tpu_torch.parallel.seqpar import (make_seq_tp_videomae_train_step,
                                           make_seq_videomae_train_step)
from bvc_tpu_torch.parallel.sharding import param_shardings
from bvc_tpu_torch.training.checkpoint import (checkpoint_exists, checkpoint_path,
                                               checkpoint_saver, load_checkpoint, load_meta,
                                               load_optimizer_state, optimizer_state_dict)
from bvc_tpu_torch.training.metrics_pipe import MetricsPipe
from bvc_tpu_torch.training.optim import schedule_steps
from bvc_tpu_torch.training.probes import format_gstats, full_grad_probes
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_videomae_train_step
from bvc_tpu_torch.utils.config import ModelConfig, TrainConfig
from bvc_tpu_torch.utils.device import resolve_device
from bvc_tpu_torch.utils.logging import AverageMeter, CSVLogger, get_logger, is_main_process
from bvc_tpu_torch.utils.profiling import StepTraceWindow, device_memory_stats, span


def refuse_unported(cfg: TrainConfig) -> Mesh:
    """The run's mesh (:func:`~bvc_tpu_torch.parallel.make_mesh` of
    ``cfg.mesh_shape``, over the world), its parameter layout checked
    (:func:`~bvc_tpu_torch.parallel.sharding.param_shardings`; on a mesh
    with ``seq`` by the sequence-parallel steps' rules, :func:`seq_layout`;
    on a mesh with ``pipe``, where the flag must stay ``replicated``).
    Raises for a layout the run cannot take: axes whose sizes do not
    multiply to the world's, a ``pipe`` axis beside ``seq`` or ``model``,
    a flag the mesh refuses."""
    mesh = make_mesh(cfg.mesh_shape)
    if SEQ_AXIS in mesh.axis_names:
        seq_layout(cfg, mesh)
    else:
        param_shardings(cfg.param_sharding, mesh)
    return mesh


def seq_layout(cfg: TrainConfig, mesh: Mesh) -> tuple[str, Callable]:
    """``(param_sharding, step)`` of a run on a mesh with ``seq`` (the JAX
    trainer's seq branches): with a ``model`` axis the seq x TP step, whose
    flag must stay ``replicated`` while the state holds the blocks' heads
    over ``model`` (``tp``); else the seq step under the flag's layout
    (``replicated`` or ``zero1``)."""
    probes = full_grad_probes("videomae") if cfg.log_grad_stats else None
    accum = cfg.optim.grad_accum_steps
    if MODEL_AXIS in mesh.axis_names:
        if cfg.param_sharding != "replicated":
            raise ValueError(
                "the seq x tp step keeps params canonical and replicated "
                "(TP shards COMPUTE over heads, not storage) -- "
                f"--param_sharding must stay 'replicated' "
                f"(got {cfg.param_sharding!r})")
        return "tp", make_seq_tp_videomae_train_step(cfg.model, cfg.mask, probes, accum, mesh)
    return cfg.param_sharding, make_seq_videomae_train_step(
        cfg.model, cfg.mask, cfg.param_sharding, accum, probes, mesh)


def pipe_layout(cfg: TrainConfig, mesh: Mesh) -> tuple[str, Callable]:
    """``(param_sharding, step)`` of a run on a mesh with ``pipe`` (the JAX
    trainer's pipe branch): the GPipe step over ``cfg.pipe_microbatches``
    microbatches, composed with ``grad_accum_steps``; the stages define
    the layout, so the flag must stay ``replicated`` (:func:`refuse_unported`
    checks it)."""
    probes = full_grad_probes("videomae") if cfg.log_grad_stats else None
    return cfg.param_sharding, make_pipe_videomae_train_step(
        cfg.model, cfg.mask, num_microbatches=cfg.pipe_microbatches, grad_probes=probes,
        grad_accum=cfg.optim.grad_accum_steps, mesh=mesh)


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
    mesh = refuse_unported(cfg)
    world = mesh.size
    seq, pipe = SEQ_AXIS in mesh.axis_names, PIPE_AXIS in mesh.axis_names
    # a whole seq ring (pipe group) carries each batch row: the global batch
    # scales with the data axis only, as the JAX trainer's seq and pipe branches
    batch_ranks = mesh.axis_size(DATA_AXIS) if seq or pipe else world
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
    layout, step = (seq_layout(cfg, mesh) if seq else pipe_layout(cfg, mesh) if pipe
                    else (cfg.param_sharding, None))
    state = TrainState.create(model, cfg.optim, seed=cfg.seed + 1, device=device,
                              steps=schedule_steps(cfg, batch_ranks),
                              param_sharding=layout, mesh=mesh)
    start_epoch = 0
    if cfg.resume and checkpoint_exists(own_ckpt):
        # mid-stage preemption recovery: weights, optimizer, epoch and
        # step/generator (so the mask stream continues, not replays)
        logger.info("resuming from %s", own_ckpt)
        restored = load_checkpoint(own_ckpt)
        state.load_model_state_dict(videomae_model_state(restored, cfg.model))
        load_optimizer_state(state.optimizer, restored["opt"])
        state.step = int(restored["step"])
        state.generator.set_state(restored["rng"])
        start_epoch = int(restored["epoch"])
    if step is None:
        step = make_videomae_train_step(
            cfg.model, cfg.mask, grad_accum=cfg.optim.grad_accum_steps,
            grad_probes=full_grad_probes("videomae") if cfg.log_grad_stats else None)

    # data ---------------------------------------------------------------------
    datasets = make_dataset("videomae", cfg.data)
    global_batch = cfg.data.batch_size * batch_ranks
    loaders = {
        phase: DataLoader(
            ds, global_batch, shuffle=(phase == "train"), seed=cfg.seed,
            num_workers=cfg.data.num_workers, prefetch=cfg.data.prefetch,
            max_batches=cfg.max_epoch_iters,
            # val keeps every sample by padding the last batch
            drop_last=(phase == "train"), device=device,
            # a seq rank keeps its time slice of each clip
            frames=step.time_slice if seq else None,
        )
        for phase, ds in datasets.items()
        if ds is not None
    }
    logger.info("datasets: train=%d val=%s, global batch %d over %d ranks (mesh %s), "
                "%d iters/epoch, on %s", len(datasets["train"]),
                len(datasets["val"]) if datasets.get("val") else 0, global_batch, world,
                mesh.shape, len(loaders["train"]), device)
    if len(loaders["train"]) == 0:
        raise ValueError(
            f"dataset ({len(datasets['train'])} samples) is smaller than the "
            f"batch ({global_batch}); no training would happen")

    save_fn, save_wait = checkpoint_saver(cfg)
    loss_meter: dict[str, AverageMeter] = {}

    def save(epoch_done: int):
        train_loss = loss_meter.get("train", AverageMeter()).avg
        val_loss = loss_meter.get("val", AverageMeter()).avg
        model_sd = state.model_state_dict()
        save_fn(own_ckpt, {
            "model_state_dict": videomae_pretrain_to_hf_state_dict(model_sd, cfg.model),
            "qkv_k_bias": qkv_key_biases(model_sd),
            "opt": optimizer_state_dict(state.optimizer),
            "epoch": epoch_done,
            "step": state.step,
            "rng": state.generator.get_state(),
            "train_loss": train_loss, "val_loss": val_loss,
            "batch_size": cfg.data.batch_size, "world_size": world, "lr": cfg.optim.lr,
        }, meta={
            "run_id": cfg.run_id, "epoch": epoch_done,
            "train_loss": train_loss, "val_loss": val_loss,
            "batch_size": cfg.data.batch_size, "world_size": world, "lr": cfg.optim.lr,
            "family": "videomae", "script": cfg.script,
        })
        sync_hosts()  # no rank reads it before rank 0 has written it

    tracer = StepTraceWindow(cfg.profile_dir)  # no-op when unset, or off rank 0
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
                    with span("trainer.step", ranged=False):
                        metrics = step(state, batch)
                else:
                    metrics = step.eval_step(state, batch, itr)
                with span("trainer.metrics"):
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
