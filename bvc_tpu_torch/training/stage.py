"""One curriculum stage as the three trainers run it: the run's mesh and its
refusals, the output folder, CSV and checkpoint, the completed-stage skip,
the resume and the epoch loop.  Each ``trainer_*`` module keeps its model,
checkpoint converters, step factory, loaders, CSV columns and log line.

Under a process group (torchrun, :func:`bvc_tpu_torch.parallel.distributed_init`)
a stage runs over the mesh of ``cfg.mesh_shape`` with the parameters laid
out by ``cfg.param_sharding`` (:class:`~bvc_tpu_torch.training.state.TrainState`):
the global batch is ``batch_size * world`` (the flag is per GPU, as the JAX
CLIs'), each rank loads its ``data`` coordinate's block of it, and the steps
reduce the gradients and average the metrics over the data ranks.  Rank 0
alone writes the CSV, ``params_{run_id}.yaml``, the checkpoints
(synchronously: the async writer waits at world > 1) and the profiler
trace, with a barrier after each checkpoint write.  A checkpoint holds
whole tensors in the same layout under every mode, so a stage resumes or
chains under any other.

The trainer module's names that the benchmark and the tests replace for a
run (model class, step factory, ``DataLoader``, ``MetricsPipe``,
``StepTraceWindow``) are read there when the stage runs and handed in: this
module builds no model, loader or metrics pipe, and no step but the one
:func:`run_mesh` has a ``seq`` factory build to check the layout, and drops.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

from bvc_tpu_torch.parallel.collectives import sync_hosts
from bvc_tpu_torch.parallel.mesh import MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, Mesh, make_mesh
from bvc_tpu_torch.parallel.seqpar import (make_seq_tp_videomae_train_step,
                                           make_seq_videomae_train_step)
from bvc_tpu_torch.parallel.sharding import param_shardings
from bvc_tpu_torch.training.checkpoint import (checkpoint_exists, checkpoint_path,
                                               checkpoint_saver, load_checkpoint, load_meta,
                                               load_optimizer_state, optimizer_state_dict)
from bvc_tpu_torch.training.probes import full_grad_probes
from bvc_tpu_torch.utils.config import TrainConfig
from bvc_tpu_torch.utils.device import resolve_device
from bvc_tpu_torch.utils.logging import AverageMeter, CSVLogger, get_logger, is_main_process
from bvc_tpu_torch.utils.profiling import span


def run_mesh(cfg: TrainConfig, family: str) -> Mesh:
    """The run's mesh (:func:`~bvc_tpu_torch.parallel.make_mesh` of
    ``cfg.mesh_shape``, over the world), its parameter layout checked
    (:func:`~bvc_tpu_torch.parallel.sharding.param_shardings`; on a mesh
    with ``seq`` by the sequence-parallel steps' rules, :func:`seq_layout`;
    on a mesh with ``pipe``, where the flag must stay ``replicated``).
    Raises for a layout the run cannot take: ``seq`` or ``pipe`` for any
    ``family`` but ``videomae`` (first for 3-D rotary positions), ``seq``,
    ``pipe`` or ``tp`` for a Hiera model, axes
    whose sizes do not multiply to the world's, a ``pipe`` axis beside
    ``seq`` or ``model``, a flag the mesh refuses."""
    if cfg.model.architecture == "hiera":
        refuse_hiera_layout(cfg)
    for axis in (SEQ_AXIS, PIPE_AXIS):
        if family == "videomae" or axis not in cfg.mesh_shape:
            continue
        if cfg.model.pos_embed == "rope3d":
            raise ValueError(
                f"pos_embed='rope3d' on a '{axis}' mesh: the {axis}-parallel steps split "
                "the blocks' tokens or layers without the tokens' ids that the rotary "
                "positions need -- use a pure-data mesh")
        raise ValueError(
            f"'{axis}' parallelism is videomae-only (this family's "
            "clips fit one chip; the axis would replicate the whole "
            "step across it and inflate global_batch with no "
            "speedup) -- use a pure-data mesh")
    mesh = make_mesh(cfg.mesh_shape)
    if SEQ_AXIS in mesh.axis_names:
        seq_layout(cfg, mesh, make_seq_videomae_train_step, make_seq_tp_videomae_train_step)
    else:
        param_shardings(cfg.param_sharding, mesh)
    return mesh


def refuse_hiera_layout(cfg: TrainConfig) -> None:
    """Raise for the layouts a Hiera model has no piece for: the ``seq``
    and ``pipe`` steps and ``tp`` split the ViT's isotropic blocks."""
    for axis, piece in ((SEQ_AXIS, "a sequence-parallel Hiera step (its windows and pooled "
                                   "stages over a ring)"),
                        (PIPE_AXIS, "a pipeline split of Hiera's stages of unequal width")):
        if axis in cfg.mesh_shape:
            raise ValueError(f"architecture 'hiera' on a '{axis}' mesh: there is no {piece} "
                             "-- use a pure-data mesh (replicated, zero1 or fsdp)")
    if cfg.param_sharding == "tp":
        raise ValueError("architecture 'hiera' with --param_sharding tp: HieraBlock has no "
                         "split of its heads over the model ranks -- use replicated, zero1 "
                         "or fsdp")


def seq_layout(cfg: TrainConfig, mesh: Mesh, seq_step: Callable,
               seq_tp_step: Callable) -> tuple[str, Callable]:
    """``(param_sharding, step)`` of a VideoMAE run on a mesh with ``seq``
    (the JAX trainer's seq branches), the step made by ``seq_step`` or
    ``seq_tp_step``: with a ``model`` axis the seq x TP step, whose flag
    must stay ``replicated`` while the state holds the blocks' heads over
    ``model`` (``tp``); else the seq step under the flag's layout
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
        return "tp", seq_tp_step(cfg.model, cfg.mask, probes, accum, mesh)
    return cfg.param_sharding, seq_step(cfg.model, cfg.mask, cfg.param_sharding, accum,
                                        probes, mesh)


class Stage:
    """One stage of ``family`` over the mesh of :func:`run_mesh`, on
    :func:`~bvc_tpu_torch.utils.device.resolve_device` of ``device``:
    ``params_{run_id}.yaml``, ``csvlog_{run_id}.csv`` of ``columns``
    (appended to when resuming) and the checkpoint :attr:`checkpoint`, all
    made after the refusals.  ``losses`` maps the checkpoint's loss keys to
    their phases (VideoMAE's ``train_loss`` and ``val_loss``): the phases
    the loop averages, the summary's ``<phase>_loss``.  Every checkpoint
    holds ``opt``, ``epoch``, ``step``, ``rng``, the losses, ``batch_size``,
    ``world_size`` and ``lr`` (``scaler: None`` after ``opt`` when
    ``scaler``, the JEPA reference's AMP scaler), its meta ``run_id``,
    ``epoch``, the losses, the same three, ``family`` and ``script``."""

    def __init__(self, cfg: TrainConfig, family: str, device, columns: tuple,
                 losses: dict[str, str], scaler: bool = False):
        self.cfg, self.family, self.losses, self.scaler = cfg, family, losses, scaler
        self.logger = get_logger(f"bvc_tpu_torch.{family}")
        self.mesh = run_mesh(cfg, family)
        self.device = resolve_device(device)
        if not cfg.savedir:
            raise ValueError("savedir is required")
        folder = Path(cfg.savedir)
        folder.mkdir(parents=True, exist_ok=True)
        self.csv = None
        if is_main_process():
            cfg.dump_yaml(folder / f"params_{cfg.run_id}.yaml")
            self.csv = CSVLogger(str(folder / f"csvlog_{cfg.run_id}.csv"), *columns,
                                 append=cfg.resume)  # keep prior epochs' rows when resuming
        self.checkpoint = checkpoint_path(folder, cfg.run_id)
        self.resuming = cfg.resume and checkpoint_exists(self.checkpoint)
        self.meters: dict[str, dict[str, AverageMeter]] = {p: {} for p in losses.values()}

    def mean(self, phase: str, key: str = "loss") -> float:
        """The mean of ``key`` over this epoch's ``phase`` steps so far."""
        meter = self.meters[phase].get(key)
        return meter.avg if meter is not None else 0.0

    def completed(self, end_epoch: int) -> dict | None:
        """The summary of a stage its checkpoint's meta says is whole (epoch
        ``end_epoch`` or past), read without the model and optimizer."""
        if not self.resuming:
            return None
        meta = load_meta(self.checkpoint)
        if int(meta.get("epoch", -1)) < end_epoch:
            return None
        self.logger.info("run already complete (epoch %s/%d) — nothing to do",
                         meta.get("epoch"), end_epoch)
        return {"checkpoint": str(self.checkpoint),
                **{f"{p}_loss": meta.get(key, 0.0) for key, p in self.losses.items()}}

    def resume(self, state, restore: Callable[[dict], None], start_epoch: int = 0) -> int:
        """The epoch the loop starts at: resuming (mid-stage preemption
        recovery), the checkpoint's, after ``restore(ckpt)`` of the family's
        weights, the optimizer, the step and the generator (the mask stream
        continues, not replays); else ``start_epoch``."""
        if not self.resuming:
            return start_epoch
        self.logger.info("resuming from %s", self.checkpoint)
        restored = load_checkpoint(self.checkpoint)
        restore(restored)
        load_optimizer_state(state.optimizer, restored["opt"])
        state.step = int(restored["step"])
        state.generator.set_state(restored["rng"])
        return int(restored["epoch"])

    def _save(self, save_fn, state, epoch_done: int, layout: Callable[[], tuple]) -> None:
        cfg = self.cfg
        keys, meta = layout()
        losses = {key: self.mean(phase) for key, phase in self.losses.items()}
        run = dict(batch_size=cfg.data.batch_size, world_size=self.mesh.size, lr=cfg.optim.lr)
        save_fn(self.checkpoint, {
            **keys, "opt": optimizer_state_dict(state.optimizer),
            **({"scaler": None} if self.scaler else {}),
            "epoch": epoch_done, "step": state.step, "rng": state.generator.get_state(),
            **losses, **run,
        }, meta={"run_id": cfg.run_id, "epoch": epoch_done, **losses, **run,
                 "family": self.family, **meta, "script": cfg.script})
        sync_hosts()  # no rank reads it before rank 0 has written it

    def run(self, state, step: Callable, loaders: dict, epochs: range, *, row: Callable,
            line: Callable, layout: Callable[[], tuple], metrics_pipe: type, tracer) -> dict:
        """Run ``epochs`` over ``loaders`` (phase -> loader; ``train`` steps
        ``step(state, batch)``, another phase ``step.eval_step(state, batch,
        itr)``), save after each epoch with ``cfg.save_every_epoch`` and after
        the last, and return the summary.  A train step runs in
        ``trainer.step`` (no range: a caller may trace from inside the step)
        after ``tracer.step()``; its metrics reach the host a step late through
        ``metrics_pipe``, pushed in ``trainer.metrics``.  Each step logged gets
        ``row(epoch, phase, itr, metrics, ms)``, its CSV row, and every
        ``cfg.log_freq`` steps ``line(...)``, the log call's arguments; a loss
        that is not finite raises.  ``layout()`` gives the family's checkpoint
        keys (before ``opt``) and meta keys (after ``family``)."""
        cfg, logger, train = self.cfg, self.logger, loaders["train"]
        if len(train) == 0:
            raise ValueError(f"dataset ({len(train.dataset)} samples) is smaller than the batch "
                             f"({train.sampler.global_batch}); no training would happen")
        save_fn, save_wait = checkpoint_saver(cfg)
        named = len(self.losses) > 1  # the epoch's line names its phase
        for epoch in epochs:
            self.meters = {p: {} for p in self.losses.values()}
            for phase, loader in loaders.items():
                ms = [0.0]

                def log_fn(itr, metrics, epoch=epoch, phase=phase, ms=ms):
                    meters = self.meters[phase]
                    for key, value in metrics.items():
                        meters.setdefault(key, AverageMeter()).update(value)
                    if self.csv is not None:
                        self.csv.log(*row(epoch, phase, itr, metrics, ms[0]))
                    if itr % cfg.log_freq == 0:
                        logger.info(*line(epoch, phase, itr, metrics, ms[0]))
                    loss = metrics["loss"]
                    if loss != loss or abs(loss) == float("inf"):
                        raise FloatingPointError(f"loss is {loss} at epoch {epoch} itr {itr}")

                # lag-1 logging: step i's row is written while step i+1 runs
                pipe = metrics_pipe(log_fn, time_every=cfg.log_freq)
                for itr, batch in enumerate(loader.epoch(epoch)):
                    if phase == "train":
                        tracer.step()
                        with span("trainer.step", ranged=False):
                            metrics = step(state, batch)
                    else:
                        metrics = step.eval_step(state, batch, itr)
                    with span("trainer.metrics"):
                        ms[0] = pipe.push(itr, metrics)
                pipe.flush()
                logger.info("epoch %d%s avg loss %.4f", epoch + 1, f" {phase}" if named else "",
                            self.mean(phase))
            if cfg.save_every_epoch and epoch + 1 < epochs.stop:
                self._save(save_fn, state, epoch + 1, layout)

        tracer.close()
        self._save(save_fn, state, epochs.stop, layout)
        save_wait()  # async: the returned path must be complete on disk
        logger.info("checkpoint saved at %s", self.checkpoint)
        return {"checkpoint": str(self.checkpoint),
                **{f"{p}_loss": self.mean(p) for p in self.losses.values()}}
