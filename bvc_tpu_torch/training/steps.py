"""The VideoMAE, JEPA and SimCLR pretraining steps (counterparts of
:func:`bvc_tpu.training.steps.make_videomae_train_step`,
:func:`~bvc_tpu.training.steps.make_jepa_train_step` and
:func:`~bvc_tpu.training.steps.make_simclr_train_step` and their
``eval_step``, unsharded).

A VideoMAE step: normalize the uint8 clips on the device, draw the tube (or
random) mask from the state's generator, take the masked-reconstruction
loss of :class:`~bvc_tpu_torch.models.videomae.VideoMAEPretrain` and its
gradients, take the optimizer's update, and read the gradient probes.
A JEPA step: the EMA target's features at the prediction positions (no
gradient), the context encoder and the predictor, the smooth-L1 loss over
the valid prediction rows, the update, then the EMA of the target encoder.  A SimCLR step: the
uint8 pairs normalized on the device and flattened to the interleaved
``[2B]`` batch, the ResNet and its head with BatchNorm over the batch, the
InfoNCE loss in f32, the update.  Each step's ``grad_probes`` (name ->
fn(model), e.g. :func:`~bvc_tpu_torch.training.probes.full_grad_probes`)
add metrics read from the gradients after the backward.
PyTorch runs eagerly, so there is no jit: a step is a plain function that
updates the state in place.  Its metrics stay device tensors, so the step
never waits for the device; the caller reads them when it needs them.

Under a process group a step takes this rank's block of the global batch
(its ``data`` coordinate's; the ``model`` ranks of a data row hold the same
block) and calls ``state.forward``: ``DistributedDataParallel`` over the
``data`` ranks, whose hooks average the gradients during the backward
(``replicated``, ``zero1``, ``tp``), or the FSDP2 module, which
reduce-scatters them (``fsdp``); so the update is the one process's at the
global batch (every sample weighs the same in each family's loss).  Under
``grad_accum > 1`` every microbatch but the last runs without the gradient
reduction (``no_sync()``, or FSDP2's ``set_requires_gradient_sync(False)``):
one reduction per optimizer step, as JAX's sharded accumulation.  The masks
are drawn for the global batch on every rank from the same generator, each
rank keeping its rows; the metrics are averaged over the data ranks (one
all-reduce) before the caller reads them, and the gradient probes read the
reduced gradients, whole (:mod:`~bvc_tpu_torch.training.probes`).
Drop-path (0 in every reference configuration) is drawn per rank from the
rank's generator, so it differs from one process's draws at the global
batch.  The eval steps call the model (``state.model``) rather than its
methods, so that FSDP2's hooks gather its parameters.  Every step also has
``step.comm_report(state, *batch)``: the collectives one step issues
(:mod:`bvc_tpu_torch.parallel.analysis`), the state left as it was.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch

from bvc_tpu_torch.masks.tube import random_mask, tube_mask
from bvc_tpu_torch.models.jepa import target_features
from bvc_tpu_torch.models.videomae import normalize_on_device
from bvc_tpu_torch.objectives.contrastive import (global_info_nce, info_nce_loss,
                                                  per_replica_info_nce_sharded)
from bvc_tpu_torch.parallel.analysis import in_accumulation, with_comm_report
from bvc_tpu_torch.parallel.collectives import psum_scalar
from bvc_tpu_torch.parallel.mesh import data_rank, data_size
from bvc_tpu_torch.training.optim import apply_schedules
from bvc_tpu_torch.training.probes import (jepa_grad_metrics, simclr_grad_metrics,
                                           videomae_grad_metrics)
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig


def microbatches(x: torch.Tensor, k: int) -> list[torch.Tensor]:
    """The ``k`` microbatches of a batch-major tensor, strided as the JAX
    package splits them: microbatch j holds the rows ``i`` with
    ``i % k == j``."""
    if x.shape[0] % k:
        raise ValueError(f"grad_accum_steps ({k}) must divide the batch ({x.shape[0]})")
    return [x[j::k] for j in range(k)]


GradProbes = dict[str, Callable[[torch.nn.Module], torch.Tensor]]


def _probed(metrics: dict[str, torch.Tensor], model: torch.nn.Module,
            grad_probes: GradProbes | None) -> dict[str, torch.Tensor]:
    for name, fn in (grad_probes or {}).items():
        metrics[name] = fn(model)
    return mean_over_ranks(metrics)


def mean_over_ranks(metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Scalar metrics averaged over the data ranks in one all-reduce, each
    in its own dtype; unchanged on a data axis of one."""
    if data_size() == 1:
        return metrics
    mean = psum_scalar(torch.stack([v.detach().float() for v in metrics.values()]))
    return {k: m.to(v.dtype) for (k, v), m in zip(metrics.items(), mean)}


@contextlib.contextmanager
def _fsdp_no_sync(model):
    model.set_requires_gradient_sync(False)
    try:
        yield
    finally:
        model.set_requires_gradient_sync(True)


@contextlib.contextmanager
def _sync_unless(state: TrainState, last: bool):
    """No gradient reduction for every microbatch but the last
    (``state.ddp.no_sync()``, or FSDP2's), so the gradients are reduced
    once per optimizer step; the collectives such a microbatch issues are
    recorded ``in_loop`` (:func:`~bvc_tpu_torch.parallel.analysis.
    in_accumulation`)."""
    if last:
        yield
        return
    if state.fsdp:
        no_sync = _fsdp_no_sync(state.model)
    else:
        no_sync = contextlib.nullcontext() if state.ddp is None else state.ddp.no_sync()
    with no_sync, in_accumulation():
        yield


def global_rows(draw: Callable[[int], torch.Tensor], local_batch: int) -> torch.Tensor:
    """This rank's rows of ``draw(global_batch)``: every rank draws for the
    whole global batch (``local_batch`` times the data ranks) from a
    generator in the same state, so the masks are one process's at the
    global batch, and the ranks of a data row draw the same rows."""
    r = data_rank()
    return draw(local_batch * data_size())[r * local_batch:(r + 1) * local_batch]


def mask_sampler(model_cfg: ModelConfig, mask_cfg: MaskConfig
                 ) -> tuple[Callable[[torch.Generator, int], torch.Tensor], int]:
    """``(draw, num_visible)``: ``draw(generator, batch)`` samples the
    ``[batch, N]`` tube or random masks of ``mask_cfg``, each row with
    ``num_visible`` False entries."""
    grid = (model_cfg.num_time_steps, model_cfg.image_size // model_cfg.patch_size,
            model_cfg.image_size // model_cfg.patch_size)
    n_space = grid[1] * grid[2]
    if mask_cfg.sampler == "tube":
        n_masked = int(mask_cfg.mask_ratio * n_space) * grid[0]
        sampler = functools.partial(tube_mask, grid=grid, mask_ratio=mask_cfg.mask_ratio)
    elif mask_cfg.sampler == "random":
        n_masked = int(mask_cfg.mask_ratio * grid[0] * n_space)
        sampler = functools.partial(random_mask, grid=grid, mask_ratio=mask_cfg.mask_ratio)
    else:
        raise ValueError(f"unknown mask sampler {mask_cfg.sampler!r}")
    return sampler, model_cfg.seq_len - n_masked


def eval_generator(state: TrainState, step_idx: int) -> torch.Generator:
    """The eval step's mask generator: seeded from the state's seed and
    ``step_idx`` (the counterpart of ``fold_in(state.rng, step_idx)``),
    the state's own untouched."""
    gen = torch.Generator(device=state.device)
    gen.manual_seed(hash((state.generator.initial_seed(), step_idx)) % 2**63)
    return gen


def make_videomae_train_step(model_cfg: ModelConfig, mask_cfg: MaskConfig,
                             grad_accum: int = 1, attn_impl: str = "auto",
                             grad_probes: GradProbes | None = None
                             ) -> Callable[..., dict[str, torch.Tensor]]:
    """``step(state, video, mask=None) -> metrics`` over uint8 (or
    normalized) ``video [B, T, H, W, C]``.

    The step updates ``state`` in place: its model's parameters, its
    optimizer's state, its step count and, when ``mask`` is None, its
    generator (the mask is drawn from it).  A given ``mask`` (``[B, N]``
    bool, True = masked, the sampler's masked count in every row) is used
    as it is, so tests can hand both packages the same one.
    ``grad_accum > 1`` averages the gradients of that many strided
    microbatches before the one update; the mean of their mean losses is
    the batch mean, since every sample has the same masked count.  Under a
    process group ``video`` (and a given ``mask``) is this rank's block of
    the global batch, and a drawn mask is the block's rows of the global
    batch's (:func:`global_rows`).
    ``attn_impl`` routes the attention of every block.

    Metrics: ``loss``, ``grad_norm``, ``grad_efl``, ``grad_ell`` and
    ``grad_dll``, scalar device tensors.  ``step.eval_step(state, video,
    step_idx=0, mask=None)`` returns ``{"loss": ...}`` without touching the
    state: its mask comes from a generator seeded from the state's seed and
    ``step_idx``, the counterpart of ``fold_in(state.rng, step_idx)``.
    """
    sampler, num_visible = mask_sampler(model_cfg, mask_cfg)

    def step(state: TrainState, video: torch.Tensor,
             mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        video = video.to(state.device, non_blocking=True)
        if mask is None:
            mask = global_rows(functools.partial(sampler, state.generator), video.shape[0])
        mask = mask.to(state.device, non_blocking=True)
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        loss = torch.zeros((), device=state.device)
        for j, (v, m) in enumerate(zip(microbatches(video, grad_accum),
                                       microbatches(mask, grad_accum))):
            with _sync_unless(state, j == grad_accum - 1):
                micro = state.forward(v, m, num_visible, attn_impl) / grad_accum
                micro.backward()
            loss += micro.detach()
        apply_schedules(opt, state.step)
        opt.step()
        state.step += 1
        return _probed({"loss": loss, **videomae_grad_metrics(model)}, model, grad_probes)

    @torch.no_grad()
    def eval_step(state: TrainState, video: torch.Tensor, step_idx: int = 0,
                  mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        video = video.to(state.device, non_blocking=True)
        if mask is None:
            mask = global_rows(functools.partial(sampler, eval_generator(state, step_idx)),
                               video.shape[0])
        mask = mask.to(state.device, non_blocking=True)
        return mean_over_ranks({"loss": state.model(video, mask, num_visible, attn_impl)})

    step.eval_step = eval_step
    return with_comm_report(step)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 in f32, ``F.smooth_l1_loss(reduction='none')``
    semantics: the reference JEPA loss."""
    d = (pred.float() - target.float()).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def make_jepa_train_step(model_cfg: ModelConfig, total_steps: int,
                         ema: tuple[float, float] = (0.996, 1.0),
                         ema_fallback: float = 0.998, grad_accum: int = 1,
                         attn_impl: str = "auto", grad_probes: GradProbes | None = None
                         ) -> Callable[..., dict[str, torch.Tensor]]:
    """``step(state, batch) -> metrics`` over a batch dict of
    ``video [B, T, H, W, C]`` (uint8 or normalized), ``enc_idx [B, Ke]`` and
    ``pred_idx [B, M, Kp]`` (int, ``-1`` padded: the collator's indices
    lifted by ``update_mask_indices``, with ``pred_idx`` batch-major).

    ``state`` holds a :class:`~bvc_tpu_torch.models.jepa.JEPA` as its model
    and the EMA target encoder as ``state.target``; the step updates the
    model, the optimizer, the step count and the target in place, and
    draws the context encoder's and the predictor's drop-path (when
    ``model_cfg.drop_path_rate > 0``) from the state's generator.  The EMA
    coefficient after update ``i`` (the state's step before it) is the
    reference's: ``ema[0] + i * (ema[1] - ema[0]) / total_steps``, not
    capped at 1, while ``i < total_steps + 5``, then ``ema_fallback``.
    ``grad_accum > 1`` averages the gradients of that many strided
    microbatches before the one update (exact: the collator gives every
    sample the same valid counts).

    ``attn_impl='auto'`` routes as the JAX step does: the context encoder
    and the predictor through ``'xla_bf16'`` when
    ``model_cfg.autocast_scores`` and the compute dtype is bf16, the target
    encoder through ``'xla_bf16'`` when ``model_cfg.target_score_bf16`` and
    bf16, each else ``'auto'``; any other value routes all three.  The
    eval step runs the online networks at ``attn_impl`` itself.

    Metrics: ``loss``, ``grad_norm``, ``grad_fl``, ``grad_ll``, ``mask_a``
    and ``mask_b`` (valid context and prediction tokens of sample 0) and
    ``ema_m``, scalar device tensors.  ``step.eval_step(state, batch)``
    returns ``{"loss": ...}`` without touching the state.
    """
    bf16 = model_cfg.dtype == "bfloat16"
    if attn_impl == "auto":
        grad_impl = "xla_bf16" if model_cfg.autocast_scores and bf16 else "auto"
        target_impl = "xla_bf16" if model_cfg.target_score_bf16 and bf16 else "auto"
    else:
        grad_impl = target_impl = attn_impl

    def jepa_loss(state: TrainState, video, enc_idx, pred_idx,
                  online_impl: str = grad_impl, train: bool = True) -> torch.Tensor:
        """Mean smooth-L1 over the valid prediction rows, ``pred_idx``
        ``[B, M, Kp]``; ``train`` draws drop-path (when the config has it)
        from the state's generator and runs the online networks through
        ``state.forward`` (DDP under a process group)."""
        pred_idx = pred_idx.transpose(0, 1)  # [M, B, Kp]
        targets = target_features(state.target, video, pred_idx, target_impl)
        valid = (pred_idx >= 0).float()[..., None]
        gen = state.generator if train else None
        online = state.forward if train else state.model
        preds = online(video, enc_idx, pred_idx, online_impl, gen)
        per = smooth_l1(preds, targets) * valid
        return per.sum() / (valid.sum().clamp(min=1.0) * preds.shape[-1])

    def on_device(state: TrainState, batch: dict) -> tuple[torch.Tensor, ...]:
        return tuple(batch[k].to(state.device, non_blocking=True)
                     for k in ("video", "enc_idx", "pred_idx"))

    def step(state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        video, enc_idx, pred_idx = on_device(state, batch)
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        loss = torch.zeros((), device=state.device)
        for j, (v, e, p) in enumerate(zip(*(microbatches(x, grad_accum)
                                            for x in (video, enc_idx, pred_idx)))):
            with _sync_unless(state, j == grad_accum - 1):
                micro = jepa_loss(state, v, e, p) / grad_accum
                micro.backward()
            loss += micro.detach()
        apply_schedules(opt, state.step)
        opt.step()

        i = state.step
        m = (ema[0] + i * (ema[1] - ema[0]) / max(total_steps, 1)
             if i < total_steps + 5 else ema_fallback)
        state.ema_update(m)
        state.step += 1
        return _probed({"loss": loss, **jepa_grad_metrics(model),
                        "mask_a": (enc_idx[0] >= 0).sum(),
                        "mask_b": (pred_idx[0, 0] >= 0).sum(),
                        # a fill on the device: a copy from the host would wait for it
                        "ema_m": torch.full((), m, device=state.device)}, model, grad_probes)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        # as the JAX eval step: the online networks at the default routing
        return mean_over_ranks(
            {"loss": jepa_loss(state, *on_device(state, batch), attn_impl, train=False)})

    step.eval_step = eval_step
    return with_comm_report(step)


def make_simclr_train_step(temperature: float = 0.1, loss_mode: str = "parity",
                           negatives: str = "global", bn_stats: str = "global",
                           grad_probes: GradProbes | None = None, grad_accum: int = 1
                           ) -> Callable[..., dict[str, torch.Tensor]]:
    """``step(state, pairs) -> metrics`` over augmentation pairs ``[B, 2, H,
    W, C]`` (uint8, or normalized).

    ``state.model`` is a :class:`~bvc_tpu_torch.models.resnet.ResNet`: its
    ``dtype`` is the compute dtype (bf16 from the f32 master weights, or
    f32); BatchNorm's statistics and InfoNCE's cosine matrix stay f32.  The
    pairs are normalized on the device and reshaped to ``[2B, H, W, C]``,
    which interleaves them (anchor0, pos0, anchor1, ...) as the reference's
    batch (``pretrain_simclr.py:320-329``) and the loss's positive mask
    expect: a concatenation of the two views would pair other rows.  The
    step runs the model in train mode, so BatchNorm normalises by the
    batch's statistics and moves its running ones, and updates the model,
    the optimizer and the step count in place.

    ``negatives`` / ``bn_stats``: ``'per_replica'`` scopes InfoNCE's
    negatives / BatchNorm's statistics to each rank (JAX's data shard): a
    rank scores its own ``[2b, 2b]`` block and the loss is the blocks'
    mean (:func:`per_replica_info_nce_sharded`), and BatchNorm takes the
    rank's own statistics.  ``'global'`` gathers every rank's features with
    their gradient and scores the ``[2B, 2B]`` matrix in the interleaved
    global order (:func:`global_info_nce`), and takes BatchNorm's
    statistics over every rank's batch.  A rank holds its block of whole
    pairs (``[b, 2, ...]``).  In one process there is one shard, so both act
    as ``'global'``, as the JAX step does at a data axis of 1.
    ``grad_accum`` must be 1: InfoNCE's negatives and BatchNorm's statistics
    span the whole batch.

    Metrics: ``loss``, ``grad_norm``, ``grad_conv1`` and ``grad_fc0``,
    scalar device tensors.  ``step.eval_step(state, pairs, step_idx=0)``
    returns ``{"loss": ...}`` with BatchNorm in eval mode (its running
    statistics), the state untouched.
    """
    if grad_accum != 1:
        raise ValueError(
            "grad_accum_steps is not supported for SimCLR: InfoNCE "
            "negatives (and BatchNorm statistics) span the whole batch, "
            "so accumulation would change the loss semantics")
    for name, value in (("negatives", negatives), ("bn_stats", bn_stats)):
        if value not in ("global", "per_replica"):
            raise ValueError(f"{name} must be 'global' or 'per_replica', got {value!r}")

    def flat_pairs(state: TrainState, pairs: torch.Tensor) -> torch.Tensor:
        x = normalize_on_device(pairs.to(state.device, non_blocking=True))
        return x.reshape(x.shape[0] * 2, *x.shape[2:])

    score = per_replica_info_nce_sharded if negatives == "per_replica" else global_info_nce

    def step(state: TrainState, pairs: torch.Tensor) -> dict[str, torch.Tensor]:
        x = flat_pairs(state, pairs)
        model, opt = state.model.train(), state.optimizer
        opt.zero_grad(set_to_none=True)
        loss = score(state.forward(x, bn_stats=bn_stats), temperature, loss_mode)
        loss.backward()
        apply_schedules(opt, state.step)
        opt.step()
        state.step += 1
        return _probed({"loss": loss.detach(), **simclr_grad_metrics(model)}, model,
                       grad_probes)

    @torch.no_grad()
    def eval_step(state: TrainState, pairs: torch.Tensor, step_idx: int = 0
                  ) -> dict[str, torch.Tensor]:
        del step_idx  # no masks to draw
        model = state.model
        was_training = model.training
        try:
            return mean_over_ranks({"loss": info_nce_loss(model.eval()(flat_pairs(state, pairs)),
                                                          temperature, loss_mode)})
        finally:
            model.train(was_training)

    step.eval_step = eval_step
    return with_comm_report(step)
