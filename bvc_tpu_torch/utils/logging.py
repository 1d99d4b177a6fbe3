"""Metrics and logging (counterpart of :mod:`bvc_tpu.utils.logging`):
``CSVLogger`` with printf-style column formats, ``AverageMeter``, the
main-process test, a stdlib logger and the NaN guard.  The opt-in
``grad_logger``/``GradStats`` table comes with ``full_grad_probes``
(ROADMAP)."""

from __future__ import annotations

import logging
import math
import os
from typing import Any

import numpy as np
import torch


class CSVLogger:
    """Append-per-iteration CSV logger.

    Column schema is declared as ``(fmt, name)`` pairs exactly like the
    reference (``predictive/loggingtools.py:31-49``), e.g.::

        CSVLogger(path, ('%d', 'epoch'), ('%d', 'itr'), ('%.5f', 'loss'))
    """

    def __init__(self, fname: str, *columns: tuple[str, str], append: bool = False):
        """``append=True`` preserves existing rows (mid-stage resume) and
        only writes the header when the file doesn't exist yet."""
        self.fname = fname
        self.types = [c[0] for c in columns]
        if append and os.path.exists(fname):
            return
        with open(self.fname, "w") as f:
            f.write(",".join(c[1] for c in columns) + "\n")

    def log(self, *values: Any) -> None:
        row = ",".join(fmt % _to_py(v) for fmt, v in zip(self.types, values))
        with open(self.fname, "a") as f:
            f.write(row + "\n")


def _to_py(v: Any):
    """0-d tensors and arrays -> Python scalars so '%'-formatting works."""
    if isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim == 0:
        return v.item()
    return v


class AverageMeter:
    """Running mean/min/max tracker (``predictive/loggingtools.py:52-75``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.max = float("-inf")
        self.min = float("inf")
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = _to_py(val)
        self.val = val
        self.max = max(val, self.max)
        self.min = min(val, self.min)
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def is_main_process() -> bool:
    """True on the process that writes checkpoints and logs: rank 0 of an
    initialised ``torch.distributed`` group, else always."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def get_logger(name: str = "bvc_tpu_torch", level: int | None = None) -> logging.Logger:
    """Stdlib logger: INFO on the main process, ERROR elsewhere
    (reference ``pretrain_jepa.py:160-165``)."""
    logging.basicConfig()
    logger = logging.getLogger(name)
    if level is None:
        level = logging.INFO if is_main_process() else logging.ERROR
    logger.setLevel(level)
    return logger


def nan_guard(loss, context: str = "") -> None:
    """Fail fast on a NaN or infinite loss (reference ``pretrain_jepa.py:469``)."""
    val = float(loss)
    if math.isnan(val) or math.isinf(val):
        raise FloatingPointError(f"loss is {val} {context}")
