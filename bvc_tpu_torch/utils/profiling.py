"""Timing and tracing (counterpart of :mod:`bvc_tpu.utils.profiling`).

- :class:`span`: a named host interval in the program's span log, an
  in-memory ring of the last ``RING_SIZE`` spans (:func:`spans` reads a
  copy).  Each record holds the name, an id, the id of the span that was
  open on the same thread when it began (0: none), the thread and
  ``time.perf_counter()`` at both ends.  Always on: about a microsecond a
  span.  While ``torch.profiler`` records, each span (but ``trainer.step``,
  see :class:`span`) is also a ``record_function`` range named
  ``bvc::<name>``;
- :func:`profiler_range`: that range alone, only while a profiler records
  (a flag check otherwise), for places too frequent for the ring;
- :func:`sync`: wait for the device (``torch.cuda.synchronize``);
- :func:`device_memory_stats`: the caching allocator's counters under the
  JAX package's key names (zeros on the CPU);
- :class:`StepTraceWindow`: one ``torch.profiler`` trace of train steps
  ``[start, start + n)`` (``--profile_dir``), written as a Chrome trace,
  with the device's kernel time, copy time, idle share (the share of the
  window in which no kernel ran) and the host and idle time by span in
  ``summary.json`` beside it; on rank 0 only under a process group (one
  timeline, not one a rank).

Spans of the program: ``trainer.step`` and ``trainer.metrics`` (the epoch
loops), ``loader.wait``, ``loader.assemble`` and ``loader.collate``
(:mod:`bvc_tpu_torch.data.loader`), ``step.inputs``, ``step.forward``,
``step.backward``, ``step.update`` and ``step.metrics`` (the VideoMAE and
JEPA steps), ``extract.call`` holding ``extract.h2d``, ``extract.forward``
and ``extract.d2h`` (:mod:`bvc_tpu_torch.evalbench.extract`); ranges alone:
``layer_norm`` (around both of its routes, the kernel's operator and the
eager chain) and ``gelu``.
"""

from __future__ import annotations

import collections
import itertools
import json
import statistics
import threading
import time
from pathlib import Path
from typing import Any

import torch

from bvc_tpu_torch.utils.logging import is_main_process

PREFIX = "bvc::"  # apart from the ``bvc_tpu_torch::`` operators
RING_SIZE = 65_536
FIELDS = ("name", "id", "parent", "thread", "t0", "t1")
OUTSIDE = "outside any span"

_ring: collections.deque = collections.deque(maxlen=RING_SIZE)
_ids = itertools.count(1)
_local = threading.local()
_autograd_profiler = torch.autograd.profiler  # its ``_is_profiler_enabled`` flag
_record_function = torch.autograd.profiler.record_function


class span:
    """``with span(name):`` records the block in the span log (see the
    module's docstring); its parent is the innermost span open on this
    thread.  ``ranged=False`` logs it without the profiler's range: for a
    span inside which a caller may start or stop a profile (the trainer's
    ``trainer.step``, around a step that a caller's wrapper may trace from
    within), since a range left open across a profile's end breaks
    PyTorch's reading of the profile (a crash in ``prof.events()``)."""

    __slots__ = ("name", "ranged", "id", "parent", "t0", "t1", "_range")

    def __init__(self, name: str, ranged: bool = True):
        self.name, self.ranged = name, ranged

    def __enter__(self) -> "span":
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        self.t0 = time.perf_counter()  # both ends before the range's own, so they pair
        if self.ranged and _autograd_profiler._is_profiler_enabled:
            self._range = _record_function(PREFIX + self.name)
            self._range.__enter__()
        else:
            self._range = None
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
        _local.stack.pop()
        _ring.append((self.name, self.id, self.parent, threading.get_ident(), self.t0, self.t1))


class _NoRange:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


def profiler_range(name: str, _profiler=_autograd_profiler, _none=_NoRange()):
    """A ``record_function`` range ``bvc::<name>`` while a profiler records;
    else a shared no-op context (a few hundred nanoseconds)."""
    if _profiler._is_profiler_enabled:
        return _record_function(PREFIX + name)
    return _none


def spans() -> list[dict]:
    """A copy of the span log, oldest first: ``{name, id, parent, thread,
    t0, t1}`` each (``perf_counter`` seconds)."""
    while True:
        try:
            recs = list(_ring)
            break
        except RuntimeError:  # another thread appended during the copy
            continue
    return [dict(zip(FIELDS, r)) for r in recs]


def _self_ms_by_name(recs: list[dict]) -> dict[str, float]:
    """Milliseconds of each span name, as self time: a span's length less
    that of its children among ``recs``."""
    child_s: dict[int, float] = collections.defaultdict(float)
    for r in recs:
        child_s[r["parent"]] += r["t1"] - r["t0"]
    out: dict[str, float] = collections.defaultdict(float)
    for r in recs:
        out[r["name"]] += (r["t1"] - r["t0"] - child_s.get(r["id"], 0.0)) * 1e3
    return dict(out)


def sync(tree: Any = None) -> None:
    """Wait until the CUDA device has finished the work queued so far; a
    no-op without one.  ``tree`` (the result being timed) is accepted for
    the JAX package's signature."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


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


def _device_spans(events) -> tuple[list, list]:
    """``(kernels, copies)``: the device's intervals of a profile (copies
    and sets apart); a host range's mirror on the device's timeline
    (``bvc::`` ranges) is neither."""
    kernels, copies = [], []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False) or e.name.startswith(PREFIX)):
            span = (e.time_range.start, e.time_range.end)
            (copies if e.name.startswith(("Memcpy", "Memset")) else kernels).append(span)
    return kernels, copies


def busy_us(events) -> tuple[float, float]:
    """Microseconds of a profile in which a kernel ran on the device, and
    in which a memory copy or set did: the union of each kind's intervals,
    so overlapping streams count once.  Only kernels make the device busy:
    the loader's host-to-device copies run on a side stream beside them."""
    kernels, copies = _device_spans(events)
    return _union_us(kernels), _union_us(copies)


def idle_ms_by_span(events, recs: list[dict]) -> dict[str, float]:
    """Device idle milliseconds of a profile with host events, by span of
    the log (``recs``, :func:`spans`): each interval between two kernels
    (after merging overlaps; copies are not busy) goes to the innermost span
    of the loop's thread (the thread of ``trainer.step``; any thread without
    one) at its middle, or to ``OUTSIDE``.  The log is put on the profile's
    clock by the median offset of the ends of its spans and of their
    ``bvc::`` ranges, matched in order where a name has as many of each."""
    kernels, _ = _device_spans(events)
    ends: dict[str, list[float]] = collections.defaultdict(list)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(PREFIX):
            ends[e.name[len(PREFIX):]].append(e.time_range.end)
    offsets = []
    for name, theirs in ends.items():
        ours = sorted(r["t1"] for r in recs if r["name"] == name)
        if len(ours) == len(theirs):
            offsets += [b - a * 1e6 for a, b in zip(ours, sorted(theirs))]
    if not kernels or not offsets:
        return {}
    off = statistics.median(offsets)
    loop = {r["thread"] for r in recs if r["name"] == "trainer.step"}
    placed = [(r["t0"] * 1e6 + off, r["t1"] * 1e6 + off, r["name"]) for r in recs
              if not loop or r["thread"] in loop]
    busy: list[list[float]] = []
    for lo, hi in sorted(kernels):
        if busy and lo <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], hi)
        else:
            busy.append([lo, hi])
    out: dict[str, float] = collections.defaultdict(float)
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = (end + start) / 2
        inside = [(hi - lo, name) for lo, hi, name in placed if lo <= mid < hi]
        out[min(inside)[1] if inside else OUTSIDE] += (start - end) / 1e3
    return dict(out)


class StepTraceWindow:
    """Capture ONE ``torch.profiler`` trace of train steps
    ``[start, start + n)``: the CLI's ``--profile_dir``.

    ``start`` defaults past step 0, so warm-up is not what gets traced.  The
    window opens and closes on a device synchronisation; on closing it
    writes ``trace.json`` (Chrome/Perfetto) and ``summary.json`` into
    ``logdir``: ``steps``, ``wall_ms``, ``device_busy_ms`` of kernels,
    ``device_copy_ms`` of memory copies and sets, ``idle_share`` (1 - busy
    / wall), ``host_ms_by_span`` (each span's self time in the span log, ms
    a traced step) and ``idle_ms_by_span`` (the device's idle ms a traced
    step by the innermost span the loop's thread was in at each gap's
    middle, :func:`idle_ms_by_span`).  The profile records every operator
    on the host, which slows a loop the host already holds back: its idle
    share reads higher than the same loop's untraced (a VideoMAE-B stage
    on an H100: 45% against 6.8% in a profile of the device alone).
    Closes at the ``step`` call past the window, or at :meth:`close` after
    the loop.  No-op when ``logdir`` is empty, and on every rank but 0.
    """

    def __init__(self, logdir: str, start: int = 1, n: int = 3):
        self.logdir = logdir if is_main_process() else ""
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
        t1 = time.perf_counter()
        wall_us = (t1 - self._t0) * 1e6
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        out = Path(self.logdir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        events = prof.events()
        busy, copy = busy_us(events)
        steps = min(self._seen, self.stop_at) - self.start
        per = 1.0 / max(steps, 1)
        recs = [r for r in spans() if r["t0"] >= self._t0 and r["t1"] <= t1]
        host = _self_ms_by_name(recs)
        idle = idle_ms_by_span(events, recs)
        (out / "summary.json").write_text(json.dumps({
            "steps": steps, "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_copy_ms": copy / 1e3,
            "idle_share": 1.0 - busy / wall_us if wall_us else None,
            "host_ms_by_span": {k: v * per for k, v in sorted(host.items())},
            "idle_ms_by_span": {k: v * per for k, v in sorted(idle.items())}}))
