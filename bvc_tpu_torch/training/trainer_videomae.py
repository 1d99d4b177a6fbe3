"""VideoMAE pretraining — one curriculum stage on one GPU or data parallel
over several (counterpart of
:func:`bvc_tpu.training.trainer_videomae.run_pretraining`, its
data-parallel branch), run by :class:`~bvc_tpu_torch.training.stage.Stage`.

Artifacts, as the JAX trainer writes them: ``csvlog_{run_id}.csv`` (epoch,
itr, train loss, val loss, grad-EFL, grad-ELL, grad-DLL),
``params_{run_id}.yaml`` and the checkpoint ``model_{run_id}.pth.tar``:
``model_state_dict`` in HF ``VideoMAEForPreTraining`` names (encoder and
decoder, as ``bvc_tpu/cli/export_torch.py`` exports), ``qkv_k_bias`` (the k
thirds of the qkv biases, which HF's layout drops), the export's
``train_loss`` and ``val_loss``, and the stage's keys (``rng``: the mask
generator's state).

Over several ranks (:mod:`~bvc_tpu_torch.training.stage`) VideoMAE also
runs on a mesh with ``seq`` (``data=D,seq=S[,model=M]``,
:mod:`bvc_tpu_torch.parallel.seqpar`): the global batch is ``batch_size *
D``, every rank of a ring loads its data block and keeps its time slice of
each clip, and the step splits the attention over the ring; and on a mesh
with ``pipe`` (``data=D,pipe=P``, :mod:`bvc_tpu_torch.parallel.pipeline`):
the global batch is ``batch_size * D``, every stage of a data row loads
the same block, and the GPipe step runs ``cfg.pipe_microbatches``
microbatches through the stages.
"""

from __future__ import annotations

import torch

from bvc_tpu_torch.data.factory import make_dataset
from bvc_tpu_torch.data.loader import DataLoader
from bvc_tpu_torch.models.convert import (qkv_key_biases,
                                          videomae_pretrain_from_hf_state_dict,
                                          videomae_pretrain_to_hf_state_dict,
                                          with_qkv_key_biases)
from bvc_tpu_torch.models.videomae import VideoMAEPretrain
from bvc_tpu_torch.parallel.mesh import DATA_AXIS, PIPE_AXIS, SEQ_AXIS
from bvc_tpu_torch.parallel.pipeline import make_pipe_videomae_train_step
from bvc_tpu_torch.parallel.seqpar import (make_seq_tp_videomae_train_step,
                                           make_seq_videomae_train_step)
from bvc_tpu_torch.training.checkpoint import load_checkpoint
from bvc_tpu_torch.training.metrics_pipe import MetricsPipe
from bvc_tpu_torch.training.optim import schedule_steps
from bvc_tpu_torch.training.probes import format_gstats, full_grad_probes
from bvc_tpu_torch.training.stage import Stage, seq_layout
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_videomae_train_step
from bvc_tpu_torch.utils.config import ModelConfig, TrainConfig
from bvc_tpu_torch.utils.profiling import StepTraceWindow, device_memory_stats

COLUMNS = (("%d", "epoch"), ("%d", "itr"), ("%.5f", "train loss"), ("%.5f", "val loss"),
           ("%.4e", "grad-EFL"), ("%.4e", "grad-ELL"), ("%.4e", "grad-DLL"))


def videomae_model_state(ckpt: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """A checkpoint's ``model_state_dict`` (HF names) as the pretraining
    model's state dict, with its ``qkv_k_bias`` entries where it has them."""
    sd = videomae_pretrain_from_hf_state_dict(ckpt["model_state_dict"], cfg)
    return with_qkv_key_biases(sd, ckpt.get("qkv_k_bias", {}))


def run_pretraining(cfg: TrainConfig, device: str | torch.device | None = None) -> dict:
    """Train one stage on ``device`` (``cuda`` when None; raises when there
    is none); returns a summary with the final losses and the checkpoint
    path."""
    stage = Stage(cfg, "videomae", device, COLUMNS, {"train_loss": "train", "val_loss": "val"})
    if (done := stage.completed(cfg.n_epoch)) is not None:
        return done
    logger, mesh, device = stage.logger, stage.mesh, stage.device
    seq, pipe = SEQ_AXIS in mesh.axis_names, PIPE_AXIS in mesh.axis_names
    # a whole seq ring (pipe group) carries each batch row: the global batch
    # scales with the data axis only, as the JAX trainer's seq and pipe branches
    batch_ranks = mesh.axis_size(DATA_AXIS) if seq or pipe else mesh.size

    # model / optimizer / state ------------------------------------------------
    model = VideoMAEPretrain(cfg.model, seed=cfg.seed)
    if cfg.init_checkpoint_path != "na":
        logger.info("init from checkpoint %s", cfg.init_checkpoint_path)
        model.load_state_dict(videomae_model_state(load_checkpoint(cfg.init_checkpoint_path),
                                                   cfg.model))
    probes = full_grad_probes("videomae") if cfg.log_grad_stats else None
    layout, step = cfg.param_sharding, None
    if seq:
        layout, step = seq_layout(cfg, mesh, make_seq_videomae_train_step,
                                  make_seq_tp_videomae_train_step)
    elif pipe:  # the GPipe step; the stages define the layout (the flag stays 'replicated')
        step = make_pipe_videomae_train_step(
            cfg.model, cfg.mask, num_microbatches=cfg.pipe_microbatches, grad_probes=probes,
            grad_accum=cfg.optim.grad_accum_steps, mesh=mesh)
    state = TrainState.create(model, cfg.optim, seed=cfg.seed + 1, device=device,
                              steps=schedule_steps(cfg, batch_ranks),
                              param_sharding=layout, mesh=mesh)
    start_epoch = stage.resume(
        state, lambda ckpt: state.load_model_state_dict(videomae_model_state(ckpt, cfg.model)))
    if step is None:
        step = make_videomae_train_step(cfg.model, cfg.mask,
                                        grad_accum=cfg.optim.grad_accum_steps, grad_probes=probes)

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
                len(datasets["val"]) if datasets.get("val") else 0, global_batch, mesh.size,
                mesh.shape, len(loaders["train"]), device)

    def row(epoch, phase, itr, metrics, ms):
        loss, train = metrics["loss"], phase == "train"
        return (epoch + 1, itr, loss if train else 0.0, 0.0 if train else loss,
                *(metrics.get(k, 0.0) if train else 0.0
                  for k in ("grad_efl", "grad_ell", "grad_dll")))

    def line(epoch, phase, itr, metrics, ms):
        mem = device_memory_stats(device)["peak_bytes_in_use"] / 1024**2
        return ("[%d, %5d] %s loss: %.3f [mem: %.2e MB] (%.0f ms/it)%s", epoch + 1, itr,
                phase, stage.mean(phase), mem, ms, format_gstats(metrics))

    def checkpoint():
        model_sd = state.model_state_dict()
        return {"model_state_dict": videomae_pretrain_to_hf_state_dict(model_sd, cfg.model),
                "qkv_k_bias": qkv_key_biases(model_sd)}, {}

    return stage.run(state, step, loaders, range(start_epoch, cfg.n_epoch), row=row,
                     line=line, layout=checkpoint, metrics_pipe=MetricsPipe,
                     tracer=StepTraceWindow(cfg.profile_dir))
