"""The VideoMAE pretraining step (counterpart of
:func:`bvc_tpu.training.steps.make_videomae_train_step` and its
``eval_step``, unsharded).

One step: normalize the uint8 clips on the device, draw the tube (or
random) mask from the state's generator, take the masked-reconstruction
loss of :class:`~bvc_tpu_torch.models.videomae.VideoMAEPretrain` and its
gradients, take the optimizer's update, and read the gradient probes.
PyTorch runs eagerly, so there is no jit: the step is a plain function
that updates the state in place.  Its metrics stay device tensors, so the
step never waits for the device; the caller reads them when it needs them.
Mesh, sharding and ``shard_map`` come with the multi-GPU slice.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from bvc_tpu_torch.masks.tube import random_mask, tube_mask
from bvc_tpu_torch.training.optim import apply_schedules
from bvc_tpu_torch.training.probes import videomae_grad_metrics
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
