"""Lag-1 metrics pipeline: log step i-1 while step i runs (counterpart of
:mod:`bvc_tpu.training.metrics_pipe`).

A step's metrics are device tensors.  Reading one with ``float(t)`` copies
it to the host in the stream's order, after every kernel queued so far:
read once the next step is queued, it would wait for that step too and
drain the queue every iteration.  So when a step's metrics arrive they are
stacked and copied to (pinned) host memory without blocking, an event is
recorded right behind the copy, and they are read one step later, after
waiting on that event alone: the next step stays queued on the device
while the host waits.  On the CPU the values are read directly.

The per-step wall time is taken at those reads: every ``time_every`` steps,
the time since the last such read over the steps in between.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


class _Fetch:
    """One step's metrics on their way to the host."""

    def __init__(self, metrics: dict):
        self.keys = list(metrics)
        values = torch.stack([torch.as_tensor(v).to(torch.float64) for v in metrics.values()])
        self.event = None
        if values.is_cuda:
            self.values = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
            self.values.copy_(values, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.values = values

    def result(self) -> dict[str, float]:
        if self.event is not None:
            self.event.synchronize()  # this step's metrics, not the steps queued after
        return dict(zip(self.keys, self.values.tolist()))


class MetricsPipe:
    """Wraps the per-iteration ``metrics = step(...)`` loop.

    Usage::

        pipe = MetricsPipe(log_fn, time_every=10)
        for itr, batch in enumerate(loader):
            metrics = step(state, batch)
            pipe.push(itr, metrics)   # logs itr-1's metrics
        pipe.flush()                  # logs the final step

    ``log_fn(itr, values)`` gets the metrics as Python floats.
    """

    def __init__(self, log_fn: Callable[[int, dict], None], time_every: int = 10):
        self.log_fn = log_fn
        self.time_every = max(1, time_every)
        self._pending: tuple[int, _Fetch] | None = None
        self._t_last: float | None = None
        self._last_ms = 0.0
        self._count_since_time = 0

    def _emit(self) -> None:
        itr, fetch = self._pending
        self._pending = None
        values = fetch.result()  # waits for that step only
        now = time.perf_counter()
        if self._t_last is None:
            self._t_last, self._count_since_time = now, 0
        elif self._count_since_time >= self.time_every:
            self._last_ms = (now - self._t_last) * 1e3 / self._count_since_time
            self._t_last, self._count_since_time = now, 0
        self.log_fn(itr, values)

    def push(self, itr: int, metrics: dict) -> float:
        """Start this step's metrics on their way to the host; emit the
        previous step's.  Returns the most recent per-step ms estimate."""
        fetch = _Fetch(metrics)
        if self._pending is not None:
            self._emit()
            self._count_since_time += 1
        self._pending = (itr, fetch)
        return self._last_ms

    def flush(self) -> None:
        if self._pending is not None:
            self._emit()
        self._t_last = None
