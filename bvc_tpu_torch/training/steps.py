"""The VideoMAE and JEPA pretraining steps (counterparts of
:func:`bvc_tpu.training.steps.make_videomae_train_step` and
:func:`~bvc_tpu.training.steps.make_jepa_train_step` and their
``eval_step``, unsharded).

A VideoMAE step: normalize the uint8 clips on the device, draw the tube (or
random) mask from the state's generator, take the masked-reconstruction
loss of :class:`~bvc_tpu_torch.models.videomae.VideoMAEPretrain` and its
gradients, take the optimizer's update, and read the gradient probes.
A JEPA step: the EMA target's features at the prediction positions (no
gradient), the context encoder and the predictor, the smooth-L1 loss over
the valid prediction rows, the update, then the EMA of the target encoder.
PyTorch runs eagerly, so there is no jit: a step is a plain function that
updates the state in place.  Its metrics stay device tensors, so the step
never waits for the device; the caller reads them when it needs them.
Mesh, sharding and ``shard_map`` come with the multi-GPU slice.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from bvc_tpu_torch.masks.tube import random_mask, tube_mask
from bvc_tpu_torch.models.jepa import target_features
from bvc_tpu_torch.training.optim import apply_schedules
from bvc_tpu_torch.training.probes import jepa_grad_metrics, videomae_grad_metrics
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig


def microbatches(x: torch.Tensor, k: int) -> list[torch.Tensor]:
    """The ``k`` microbatches of a batch-major tensor, strided as the JAX
    package splits them: microbatch j holds the rows ``i`` with
    ``i % k == j``."""
    if x.shape[0] % k:
        raise ValueError(f"grad_accum_steps ({k}) must divide the batch ({x.shape[0]})")
    return [x[j::k] for j in range(k)]


def make_videomae_train_step(model_cfg: ModelConfig, mask_cfg: MaskConfig,
                             grad_accum: int = 1, attn_impl: str = "auto"
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
    the batch mean, since every sample has the same masked count.
    ``attn_impl`` routes the attention of every block.

    Metrics: ``loss``, ``grad_norm``, ``grad_efl``, ``grad_ell`` and
    ``grad_dll``, scalar device tensors.  ``step.eval_step(state, video,
    step_idx=0, mask=None)`` returns ``{"loss": ...}`` without touching the
    state: its mask comes from a generator seeded from the state's seed and
    ``step_idx``, the counterpart of ``fold_in(state.rng, step_idx)``.
    """
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
    num_visible = model_cfg.seq_len - n_masked

    def step(state: TrainState, video: torch.Tensor,
             mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        video = video.to(state.device, non_blocking=True)
        if mask is None:
            mask = sampler(state.generator, video.shape[0])
        mask = mask.to(state.device, non_blocking=True)
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        loss = torch.zeros((), device=state.device)
        for v, m in zip(microbatches(video, grad_accum), microbatches(mask, grad_accum)):
            micro = model.pretrain_loss(v, m, num_visible, attn_impl) / grad_accum
            micro.backward()
            loss += micro.detach()
        apply_schedules(opt, state.step)
        opt.step()
        state.step += 1
        return {"loss": loss, **videomae_grad_metrics(model)}

    @torch.no_grad()
    def eval_step(state: TrainState, video: torch.Tensor, step_idx: int = 0,
                  mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        video = video.to(state.device, non_blocking=True)
        if mask is None:
            gen = torch.Generator(device=state.device)
            gen.manual_seed(hash((state.generator.initial_seed(), step_idx)) % 2**63)
            mask = sampler(gen, video.shape[0])
        mask = mask.to(state.device, non_blocking=True)
        return {"loss": state.model.pretrain_loss(video, mask, num_visible, attn_impl)}

    step.eval_step = eval_step
    return step


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 in f32, ``F.smooth_l1_loss(reduction='none')``
    semantics: the reference JEPA loss."""
    d = (pred.float() - target.float()).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def make_jepa_train_step(model_cfg: ModelConfig, total_steps: int,
                         ema: tuple[float, float] = (0.996, 1.0),
                         ema_fallback: float = 0.998, grad_accum: int = 1,
                         attn_impl: str = "auto"
                         ) -> Callable[..., dict[str, torch.Tensor]]:
    """``step(state, batch) -> metrics`` over a batch dict of
    ``video [B, T, H, W, C]`` (uint8 or normalized), ``enc_idx [B, Ke]`` and
    ``pred_idx [B, M, Kp]`` (int, ``-1`` padded: the collator's indices
    lifted by ``update_mask_indices``, with ``pred_idx`` batch-major).

    ``state`` holds a :class:`~bvc_tpu_torch.models.jepa.JEPA` as its model
    and the EMA target encoder as ``state.target``; the step updates the
    model, the optimizer, the step count and the target in place.  The EMA
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
                  online_impl: str = grad_impl) -> torch.Tensor:
        """Mean smooth-L1 over the valid prediction rows, ``pred_idx``
        ``[B, M, Kp]``."""
        pred_idx = pred_idx.transpose(0, 1)  # [M, B, Kp]
        targets = target_features(state.target, video, pred_idx, target_impl)
        valid = (pred_idx >= 0).float()[..., None]
        model = state.model
        z = model.encoder(video, enc_idx, online_impl)
        preds = model.predictor(z, enc_idx, pred_idx, online_impl)
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
        for v, e, p in zip(*(microbatches(x, grad_accum) for x in (video, enc_idx, pred_idx))):
            micro = jepa_loss(state, v, e, p) / grad_accum
            micro.backward()
            loss += micro.detach()
        apply_schedules(opt, state.step)
        opt.step()

        i = state.step
        m = (ema[0] + i * (ema[1] - ema[0]) / max(total_steps, 1)
             if i < total_steps + 5 else ema_fallback)
        with torch.no_grad():
            target = list(state.target.parameters())
            torch._foreach_mul_(target, m)
            torch._foreach_add_(target, list(model.encoder.parameters()), alpha=1.0 - m)
        state.step += 1
        return {"loss": loss, **jepa_grad_metrics(model),
                "mask_a": (enc_idx[0] >= 0).sum(), "mask_b": (pred_idx[0, 0] >= 0).sum(),
                # a fill on the device: a copy from the host would wait for it
                "ema_m": torch.full((), m, device=state.device)}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        # as the JAX eval step: the online networks at the default routing
        return {"loss": jepa_loss(state, *on_device(state, batch), attn_impl)}

    step.eval_step = eval_step
    return step
