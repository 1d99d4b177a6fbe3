"""Checkpoint save/load with the reference's artifact contract
(counterpart of :mod:`bvc_tpu.training.checkpoint`).

The reference saves ``model_{run_id}.pth.tar`` torch dicts
(``generative/pretrain_videomae.py:72-85``; JEPA three-model variant at
``pretrain_jepa.py:126-142``) and threads them between curriculum stages by
the file name.  The port writes that file itself, through ``torch.save``,
in the layout ``bvc_tpu/cli/export_torch.py`` exports (see the trainers),
plus what a resume needs: ``opt`` (the optimizer's ``state_dict``),
``epoch``, ``step``, ``rng`` (the mask generator's state) and ``meta``
(plain Python values).  Everything in it loads with
``torch.load(..., weights_only=True)``.

Crash safety, for one file: the new checkpoint is written under a
temporary name and renamed to ``<path>.new`` once complete; the previous
checkpoint is parked at ``<path>.old``, ``.new`` is renamed in, then
``.old`` is deleted.  At every instant a complete checkpoint exists; a
death inside the swap leaves ``.new`` and/or ``.old``, the next save
finishes the swap (:func:`_recover_interrupted_swap`) and the readers take
the survivor (:func:`_resolve_ckpt_file`).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import torch

from bvc_tpu_torch.parallel.sharding import full_tensor, local_part
from bvc_tpu_torch.utils.logging import is_main_process


def checkpoint_path(savedir: str | Path, run_id: str) -> Path:
    return Path(savedir) / f"model_{run_id}.pth.tar"


def _siblings(path: Path) -> tuple[Path, Path]:
    return path.with_name(path.name + ".new"), path.with_name(path.name + ".old")


def plain(value: Any) -> Any:
    """``value`` with numpy scalars and 0-d tensors turned into Python
    numbers, recursively, so that ``weights_only`` loading accepts it."""
    if isinstance(value, dict):
        return {str(k): plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if hasattr(value, "item") and getattr(value, "ndim", None) == 0:
        return value.item()
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    return str(value)


def save_checkpoint(path: str | Path, state: dict[str, Any],
                    meta: dict[str, Any] | None = None) -> None:
    """Save ``state`` (tensors, state dicts, Python values) and ``meta``
    under the key ``meta`` at ``path``, on the main process only."""
    if not is_main_process():
        return
    path = Path(path)
    new, old = _siblings(path)
    _recover_interrupted_swap(path)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save({**state, "meta": plain(meta or {})}, tmp)
    os.replace(tmp, new)  # .new only ever names a complete file
    if path.exists():
        os.replace(path, old)
    os.replace(new, path)
    old.unlink(missing_ok=True)


def _recover_interrupted_swap(path: Path) -> None:
    """Finish a swap a previous process died inside: if ``path`` is
    missing but ``.new`` (preferred, the newer save) or ``.old`` exists,
    move the survivor in; a surviving ``.old`` beside ``path`` goes."""
    new, old = _siblings(path)
    if not path.exists():
        for alt in (new, old):
            if alt.exists():
                os.replace(alt, path)
                break
    for stale in (new, old):
        stale.unlink(missing_ok=True)


def checkpoint_exists(path: str | Path) -> bool:
    """True when a loadable checkpoint exists at ``path``, including the
    ``.new``/``.old`` survivors of an interrupted swap."""
    return _resolve_ckpt_file(Path(path)).exists()


def _resolve_ckpt_file(path: Path) -> Path:
    """The file holding the checkpoint: ``path`` itself, or a ``.new`` /
    ``.old`` survivor of an interrupted swap (read only: no renames, so
    concurrent readers are safe)."""
    if path.exists():
        return path
    for alt in _siblings(path):
        if alt.exists():
            return alt
    return path


def load_checkpoint(path: str | Path, map_location: str | torch.device = "cpu"
                    ) -> dict[str, Any]:
    """The dict saved at ``path`` (or its survivor), tensors on
    ``map_location``."""
    return torch.load(_resolve_ckpt_file(Path(path)), map_location=map_location,
                      weights_only=True)


def load_meta(path: str | Path) -> dict[str, Any]:
    """The ``meta`` of the checkpoint at ``path``, without reading its
    tensors (the file is memory-mapped on the CPU); ``{}`` when there is
    none."""
    file = _resolve_ckpt_file(Path(path))
    if not file.exists():
        return {}
    return torch.load(file, map_location="cpu", weights_only=True, mmap=True).get("meta", {})


def _indexed_params(optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
    """The parameters in ``state_dict`` index order: group by group."""
    return [p for group in optimizer.param_groups for p in group["params"]]


def _is_zero(optimizer: torch.optim.Optimizer) -> bool:
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return isinstance(optimizer, ZeroRedundancyOptimizer)


def optimizer_state_dict(optimizer: torch.optim.Optimizer) -> dict | None:
    """``optimizer.state_dict()`` with whole tensors, whatever the layout:
    the one file format of every ``--param_sharding``.  A collective under
    a process group: ``zero1`` consolidates the partitions on rank 0
    (``consolidate_state_dict(to=0)``) and returns None on the other ranks;
    ``fsdp`` and ``tp`` gather each state tensor in its parameter's layout
    on every rank; a pipeline stage's optimizer gathers every stage's state
    over ``pipe`` (:mod:`bvc_tpu_torch.parallel.pipeline`)."""
    if _is_zero(optimizer):
        optimizer.consolidate_state_dict(to=0)
        return optimizer.state_dict() if is_main_process() else None
    stage = getattr(optimizer, "pipe_stage", None)
    if stage is not None:
        return stage.whole_optimizer_state(optimizer)
    sd = optimizer.state_dict()
    params = _indexed_params(optimizer)
    sd["state"] = {i: {k: full_tensor(params[i], v) if torch.is_tensor(v) and v.ndim else v
                       for k, v in st.items()}
                   for i, st in sd["state"].items()}
    return sd


def load_optimizer_state(optimizer: torch.optim.Optimizer, saved: dict) -> None:
    """Load a saved optimizer ``state_dict``'s per-parameter state (e.g.
    momentum, whole tensors) into ``optimizer``, keeping its own
    hyper-parameters: as optax's state, which holds no learning rate, a
    stage chained with other flags runs at its own.  Each rank takes its
    parts in its parameters' layout; a ``ZeroRedundancyOptimizer`` keeps
    the partition it owns, a pipeline stage's optimizer its parameters'
    state."""
    stage = getattr(optimizer, "pipe_stage", None)
    if stage is not None:
        saved = stage.stage_optimizer_state(saved)
    params = _indexed_params(optimizer)
    groups, start = [], 0
    for group in optimizer.param_groups:
        n = len(group["params"])
        groups.append({**{k: v for k, v in group.items() if k != "params"},
                       "params": list(range(start, start + n))})
        start += n
    zero = _is_zero(optimizer)  # takes whole tensors and keeps the ones it owns
    state = {int(i): {k: local_part(params[int(i)], v)
                      if torch.is_tensor(v) and v.ndim and not zero else v
                      for k, v in st.items()}
             for i, st in saved["state"].items()}
    optimizer.load_state_dict({"state": state, "param_groups": groups})


def checkpoint_saver(cfg) -> tuple[Any, Any]:
    """(save_fn, wait_fn) for a trainer: plain :func:`save_checkpoint`, or
    the background :class:`AsyncCheckpointWriter`'s save when
    ``cfg.async_save`` (``wait_fn`` must run before the checkpoint path is
    returned, so the file is complete on disk)."""
    if getattr(cfg, "async_save", False):
        from bvc_tpu_torch.training.async_checkpoint import AsyncCheckpointWriter

        writer = AsyncCheckpointWriter()
        return writer.save, writer.wait
    return save_checkpoint, lambda: None
