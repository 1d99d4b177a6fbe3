"""Timing and tracing (counterpart of :mod:`bvc_tpu.utils.profiling`).

- :class:`StepTimer`: wall-clock ms of a closure, synchronised with the
  device so queued work is counted;
- :func:`sync`: wait for the device (``torch.cuda.synchronize``);
- :func:`device_memory_stats`: the caching allocator's counters under the
  JAX package's key names (zeros on the CPU);
- :class:`StepTraceWindow`: one ``torch.profiler`` trace of train steps
  ``[start, start + n)`` (``--profile_dir``), written as a Chrome trace,
  with the device's kernel time, copy time and idle share (the share of
  the window in which no kernel ran) in ``summary.json`` beside it.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Callable

import torch


def sync(tree: Any = None) -> None:
    """Wait until the CUDA device has finished the work queued so far; a
    no-op without one.  ``tree`` (the result being timed) is accepted for
    the JAX package's signature."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class StepTimer:
    """Times closures in milliseconds, device-synchronised."""

    def __call__(self, closure: Callable[[], Any]) -> tuple[Any, float]:
        t0 = time.perf_counter()
        result = closure()
        sync(result)
        return result, (time.perf_counter() - t0) * 1e3


def device_memory_stats(device: torch.device | str | None = None) -> dict[str, float]:
    """Bytes in use, peak and total of a CUDA device; zeros on the CPU."""
    device = torch.device(device) if device is not None else None
    if (device is not None and device.type != "cuda") or not torch.cuda.is_available():
        return {"bytes_in_use": 0.0, "peak_bytes_in_use": 0.0, "bytes_limit": 0.0}
    return {
        "bytes_in_use": float(torch.cuda.memory_allocated(device)),
        "peak_bytes_in_use": float(torch.cuda.max_memory_allocated(device)),
        "bytes_limit": float(torch.cuda.get_device_properties(device).total_memory),
    }


def _union_us(spans) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def busy_us(events) -> tuple[float, float]:
    """Microseconds of a profile in which a kernel ran on the device, and
    in which a memory copy or set did: the union of each kind's intervals,
    so overlapping streams count once.  Only kernels make the device busy:
    the loader's host-to-device copies run on a side stream beside them."""
    kernels, copies = [], []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            span = (e.time_range.start, e.time_range.end)
            (copies if e.name.startswith(("Memcpy", "Memset")) else kernels).append(span)
    return _union_us(kernels), _union_us(copies)


class StepTraceWindow:
    """Capture ONE ``torch.profiler`` trace of train steps
    ``[start, start + n)``: the CLI's ``--profile_dir``.

    ``start`` defaults past step 0, so warm-up is not what gets traced.  The
    window opens and closes on a device synchronisation; on closing it
    writes ``trace.json`` (Chrome/Perfetto) and ``summary.json`` (``steps``,
    ``wall_ms``, ``device_busy_ms`` of kernels, ``device_copy_ms`` of memory
    copies and sets, ``idle_share``: 1 - busy / wall) into ``logdir``.
    Closes at the ``step`` call past the window, or at :meth:`close` after
    the loop.  No-op when ``logdir`` is empty.
    """

    def __init__(self, logdir: str, start: int = 1, n: int = 3):
        self.logdir = logdir
        self.start, self.stop_at = start, start + n
        self._seen = 0
        self._prof = None
        self._t0 = 0.0

    def step(self, _itr: int | None = None) -> None:
        """Call once per train step (before dispatching it)."""
        if not self.logdir:
            return
        if self._seen == self.start and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            sync()
            self._prof = profile(activities=activities)
            self._prof.__enter__()
            self._t0 = time.perf_counter()
        elif self._seen == self.stop_at:
            self.close()
        self._seen += 1

    def close(self) -> None:
        if self._prof is None:
            return
        sync()
        wall_us = (time.perf_counter() - self._t0) * 1e6
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        out = Path(self.logdir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        busy, copy = busy_us(prof.events())
        (out / "summary.json").write_text(json.dumps({
            "steps": min(self._seen, self.stop_at) - self.start,
            "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_copy_ms": copy / 1e3,
            "idle_share": 1.0 - busy / wall_us if wall_us else None}))
