"""Asynchronous checkpoint writes: overlap serialization with training
(counterpart of :mod:`bvc_tpu.training.async_checkpoint`).

:class:`AsyncCheckpointWriter` splits a save into

1. a synchronous **snapshot**: a CPU copy of every tensor of the state
   (model entries, optimizer state, generator state), taken before the next
   step mutates them in place;
2. a background **write**: ``torch.save`` and the crash-safe swap of
   :func:`bvc_tpu_torch.training.checkpoint.save_checkpoint` on a thread.

Overlapping saves serialize: a new :meth:`save` first waits for the
previous write.  Under a process group of several ranks a save is
synchronous (as the JAX writer's multi-host save): rank 0 writes, and the
trainer's barrier after it must find the file complete.  An exception raised in the background propagates at the
next :meth:`save`/:meth:`wait`, so a failed checkpoint is never silent.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Any

import torch

from bvc_tpu_torch.parallel.mesh import world_size
from bvc_tpu_torch.training.checkpoint import save_checkpoint
from bvc_tpu_torch.utils.logging import get_logger

logger = get_logger("bvc_tpu_torch.async_checkpoint")


def cpu_snapshot(tree: Any) -> Any:
    """A copy of ``tree`` whose tensors are fresh CPU tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: cpu_snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cpu_snapshot(v) for v in tree)
    return tree


class AsyncCheckpointWriter:
    """Background checkpoint writer with snapshot isolation.

    Usage::

        writer = AsyncCheckpointWriter()
        writer.save(path, state, meta)   # returns once snapshotted
        ...                               # training continues
        writer.wait()                     # before reading the file
    """

    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None

    def save(self, path: str | Path, state: dict[str, Any],
             meta: dict[str, Any] | None = None) -> None:
        """Snapshot ``state`` to the host and schedule the write; the caller
        may mutate the live state as soon as this returns."""
        self.wait()  # serialize with (and surface errors from) the previous write
        if world_size() > 1:
            save_checkpoint(path, state, meta)
            return
        snapshot = cpu_snapshot(state)
        self._thread = threading.Thread(target=self._write, args=(Path(path), snapshot, meta),
                                        name="bvc-ckpt-writer", daemon=True)
        self._thread.start()

    def _write(self, path: Path, snapshot: dict, meta: dict | None) -> None:
        try:
            save_checkpoint(path, snapshot, meta)
        except BaseException as e:  # surfaced at the next save()/wait()
            logger.error("async checkpoint write to %s failed: %s", path, e)
            self._exc = e

    def wait(self) -> None:
        """Block until the pending write (if any) completes; re-raise its
        error if it failed."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        exc, self._exc = self._exc, None
        if exc is not None:
            raise exc

    @property
    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()
