"""Optimizers (counterpart of :mod:`bvc_tpu.training.optim`).

PyTorch's own optimizers, configured to compute what the JAX package's
optax chains compute (the JAX side has no kernel for them):

- ``sgd``: ``torch.optim.SGD`` with Nesterov momentum and coupled L2 weight
  decay (added to the gradient before the momentum buffer), the default of
  every trainer;
- ``adamw``: ``torch.optim.AdamW`` with betas ``(adam_b1, adam_b2)`` and
  decoupled decay, ``p -= lr * (adam_update + wd * p)`` as optax's
  ``adamw``;
- ``adam``: ``torch.optim.Adam`` with coupled weight decay and its default
  betas (0.9, 0.999), as optax's ``adam`` after ``add_decayed_weights``.

``exclude_bias_and_norm_from_wd`` puts the tensors with ``ndim < 2`` into a
param group without weight decay (:func:`wd_mask`).  The two schedules,
:func:`warmup_cosine_lr` and :func:`cosine_wd`, are functions of the count
of updates taken; :func:`apply_schedules` writes their values into the param
groups before each update.

Under ``--param_sharding zero1`` the optimizer is a
``ZeroRedundancyOptimizer`` over the ``data`` ranks (``zero_group``): its
``param_groups`` (which :func:`apply_schedules` writes) reach the rank's
local optimizer at every ``step``, which updates the whole tensors the rank
owns and broadcasts them.  Under ``fsdp`` the same optimizers step the
``DTensor`` shards, under ``tp`` the rank's parts of the split tensors.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from bvc_tpu_torch.utils.config import OptimConfig


def wd_mask(named_params: Iterable[tuple[str, torch.Tensor]]) -> dict[str, bool]:
    """True for the tensors that take weight decay: ``ndim >= 2``."""
    return {name: p.ndim >= 2 for name, p in named_params}


def grouped_names(cfg: OptimConfig, named_params: Iterable[tuple[str, torch.Tensor]]
                  ) -> list[tuple[bool, list[str]]]:
    """The optimizer's parameter groups as ``(decay, names)``, in the
    order of its ``state_dict`` indices: the tensors that take weight
    decay, then the others (biases and norms, when
    ``cfg.exclude_bias_and_norm_from_wd``), each in ``named_params``'
    order; an empty group is left out."""
    named_params = list(named_params)
    decays = (wd_mask(named_params) if cfg.exclude_bias_and_norm_from_wd
              else {name: True for name, _ in named_params})
    groups = [(decay, [n for n, _ in named_params if decays[n] == decay])
              for decay in (True, False)]
    return [(decay, names) for decay, names in groups if names]


def warmup_cosine_lr(start: float, peak: float, final: float, warmup_steps: int,
                     total_steps: int) -> Callable[[int], float]:
    """``count -> lr``: linear ``start -> peak`` over ``warmup_steps``, then
    cosine ``peak -> final`` over the remaining ``total_steps -
    warmup_steps``, floored at ``final``."""

    def fn(count: int) -> float:
        if count < warmup_steps:
            return start + (peak - start) * count / max(1, warmup_steps)
        prog = min(max((count - warmup_steps) / max(1, total_steps - warmup_steps), 0.0), 1.0)
        return max(final + (peak - final) * 0.5 * (1.0 + math.cos(math.pi * prog)), final)

    return fn


def cosine_wd(ref: float, final: float, total_steps: int) -> Callable[[int], float]:
    """``count -> wd``: cosine ``ref -> final`` over ``total_steps``, held
    at ``final`` past the horizon (in whichever direction final lies)."""

    def fn(count: int) -> float:
        prog = min(max(count / max(1, total_steps), 0.0), 1.0)
        val = final + (ref - final) * 0.5 * (1.0 + math.cos(math.pi * prog))
        return max(val, final) if final <= ref else min(val, final)

    return fn


def make_optimizer(cfg: OptimConfig, named_params: Iterable[tuple[str, torch.nn.Parameter]],
                   steps: tuple[int, int] | None = None, zero_group=None
                   ) -> torch.optim.Optimizer:
    """The optimizer of ``cfg`` over ``named_params`` (e.g.
    ``model.named_parameters()``).

    ``steps = (warmup_steps, total_steps)`` is required when
    ``cfg.schedule`` or ``cfg.final_wd`` enables a schedule; the optimizer
    then carries ``lr_fn`` and ``wd_fn`` (None when off) for
    :func:`apply_schedules`.  ``zero_group`` (a process group, or the
    world's as ``torch.distributed.group.WORLD``) partitions the state over
    its ranks in a ``ZeroRedundancyOptimizer``."""
    named_params = list(named_params)
    wd = cfg.weight_decay
    lr_fn = wd_fn = None
    if cfg.schedule not in ("none", "warmup_cosine"):
        raise ValueError(f"invalid schedule {cfg.schedule!r}")
    if cfg.schedule == "warmup_cosine" or cfg.final_wd is not None:
        if steps is None:
            raise ValueError("schedule/final_wd configured but no (warmup, total) "
                             "steps given")
        warmup_steps, total_steps = steps
        if cfg.schedule == "warmup_cosine":
            lr_fn = warmup_cosine_lr(cfg.start_lr, cfg.lr, cfg.final_lr, warmup_steps,
                                     total_steps)
        if cfg.final_wd is not None:
            if not wd:
                raise ValueError("final_wd configured but weight_decay is 0")
            if cfg.name == "adamw":
                raise NotImplementedError(
                    "final_wd scheduling is coupled-wd (sgd/adam); adamw's "
                    "decoupled decay is not scheduled")
            wd_fn = cosine_wd(wd, cfg.final_wd, total_steps)

    by_name = dict(named_params)
    groups = [{"params": [by_name[n] for n in names], "weight_decay": wd if decay else 0.0,
               "decay": decay}
              for decay, names in grouped_names(cfg, named_params)]
    lr = lr_fn(0) if lr_fn is not None else cfg.lr
    if cfg.name == "sgd":
        cls, kwargs = torch.optim.SGD, {"momentum": cfg.momentum,
                                        "nesterov": cfg.nesterov and cfg.momentum > 0}
    elif cfg.name == "adamw":
        cls, kwargs = torch.optim.AdamW, {"betas": (cfg.adam_b1, cfg.adam_b2), "eps": 1e-8}
    elif cfg.name == "adam":
        cls, kwargs = torch.optim.Adam, {"eps": 1e-8}
    else:
        raise ValueError(f"invalid optimizer {cfg.name!r}")
    if zero_group is None:
        opt = cls(groups, lr=lr, **kwargs)
    else:
        from torch.distributed.optim import ZeroRedundancyOptimizer

        opt = ZeroRedundancyOptimizer(groups, optimizer_class=cls, process_group=zero_group,
                                      lr=lr, **kwargs)
    opt.lr_fn, opt.wd_fn = lr_fn, wd_fn
    apply_schedules(opt, 0)
    return opt


def apply_schedules(opt: torch.optim.Optimizer, count: int) -> None:
    """Set the lr and the weight decay of every param group to their
    schedules' values after ``count`` updates (a no-op without schedules)."""
    for group in opt.param_groups:
        if opt.lr_fn is not None:
            group["lr"] = opt.lr_fn(count)
        if opt.wd_fn is not None and group["decay"]:
            group["weight_decay"] = opt.wd_fn(count)


def schedule_steps(cfg, world: int = 1) -> tuple[int, int] | None:
    """``(warmup_steps, total_steps)`` for a ``TrainConfig`` whose global
    batch is ``batch_size * world``, or None when no schedule is configured
    (counterpart of :func:`bvc_tpu.training.optim.schedule_steps`: ``world``
    is its mesh's device count, or its ``data`` axis on a mesh with ``seq``,
    where a whole ring carries each batch row).

    The reference's horizon ``ipe_scale * n_epoch * iterations_per_epoch``
    (``predictive/helper.py:148-161``), iterations per epoch as the
    trainers' loaders count them: ``n_trainsamples // (batch_size *
    world)``, the global batch, capped by ``max_epoch_iters``."""
    o = cfg.optim
    if o.schedule == "none" and o.final_wd is None:
        return None
    ipe = max(1, cfg.data.n_trainsamples // max(1, cfg.data.batch_size * world))
    if cfg.max_epoch_iters:
        ipe = min(ipe, cfg.max_epoch_iters)
    total = max(1, int(o.ipe_scale * cfg.n_epoch * ipe))
    warmup = min(int(o.warmup_epochs * ipe), total)
    return warmup, total
