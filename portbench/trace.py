"""Host spans and the reduction of a ``torch.profiler`` trace.

:class:`Spans` records the benchmark's own spans around its calls into the
program's layers (host clock; in a traced run also as
``record_function`` ranges named ``portbench/<name>``, so that the trace
can say which span the host was in when the device sat idle).

:class:`TraceView` reads a finished profile once: the device's kernels
(memory copies and sets apart: they do not make the device busy), the
operators with their input shapes and the device time of the kernels
launched under them, and the spans.  The per-layer metrics read it.

A traced run makes two profiles after its window: one of the device alone
(``ProfilerActivity.CUDA``), whose own cost on the host is small, for the
idle share, the busy time, the kernels by name and the idle gaps; then one
of the host's operators too, with their shapes, for the operators' device
time.  Recording every operator on the host slows a loop that the host
already holds back, so the second profile's idle share would read the
profiler.  The first has no host events: its host spans are the
benchmark's own, put on the device's clock by a marker kernel launched
onto an idle device at a known host time (:func:`start_device_trace`).
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

from portbench import arith

SPAN_PREFIX = "portbench/"


class Spans:
    """Named host intervals (``time.perf_counter`` seconds)."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.items: dict[str, list[tuple[float, float]]] = collections.defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = (torch.profiler.record_function(SPAN_PREFIX + name) if self.traced
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            try:
                yield
            finally:
                self.items[name].append((t0, time.perf_counter()))


def start_device_trace(device):
    """A profile of the device alone, started on an idle device, with its
    first kernel launched at the returned host time; ``(prof, marker_s)``."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    torch.cuda.synchronize(device)
    marker_s = time.perf_counter()
    torch.ones(1, device=device)
    return prof, marker_s


def start_op_trace(device):
    """A profile of the host's operators, with their shapes, and the
    device's kernels."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts, record_shapes=True)
    prof.__enter__()
    return prof


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


class TraceView:
    """What the metrics read of one traced window."""

    def __init__(self, prof, window_s: float, steps: int,
                 host_spans: dict[str, list[tuple[float, float]]] | None = None,
                 marker_s: float | None = None):
        """``host_spans`` (``Spans.items``, host seconds) and ``marker_s``
        (the host time at which the profile's first kernel was launched
        onto an idle device) place the benchmark's spans on a profile
        without host events."""
        self.window_s, self.steps = window_s, steps
        self.kernels: list[tuple[str, float, float]] = []
        self.spans: list[tuple[str, float, float]] = []
        self.ops: dict[str, list[tuple[list, float]]] = collections.defaultdict(list)
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.events():
            lo, hi = e.time_range.start, e.time_range.end
            if e.device_type == cuda:
                if getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX):
                    continue  # a host range's mirror on the device's timeline, no kernel
                if not e.name.startswith(("Memcpy", "Memset")):
                    self.kernels.append((e.name, lo, hi))
            elif e.name.startswith(SPAN_PREFIX):
                self.spans.append((e.name[len(SPAN_PREFIX):], lo, hi))
            elif "::" in e.name and not e.name.startswith("aten::"):
                self.ops[e.name].append((list(e.input_shapes or []), _device_us(e)))
        if host_spans is not None and self.kernels:
            offset = min(lo for _, lo, _ in self.kernels) - marker_s * 1e6
            self.spans = [(name, lo * 1e6 + offset, hi * 1e6 + offset)
                          for name, spans in host_spans.items() for lo, hi in spans
                          if lo >= marker_s]

    def busy_us(self) -> float:
        return arith.union_us((lo, hi) for _, lo, hi in self.kernels)

    def idle_share(self) -> float | None:
        if not self.kernels:
            return None
        return 1.0 - self.busy_us() / (self.window_s * 1e6)

    def top_ops(self, n: int = 10) -> list[list]:
        total: dict[str, float] = collections.defaultdict(float)
        for name, lo, hi in self.kernels:
            total[name[:160]] += (hi - lo) * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The longest intervals of the traced window in which no kernel
        ran, each named by the benchmark span the host was in at its middle
        ("loop gap" outside every span)."""
        busy = arith.merged((lo, hi) for _, lo, hi in self.kernels)
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
        out = []
        for length, lo, hi in sorted(gaps, reverse=True)[:n]:
            mid = (lo + hi) / 2
            inside = [(s_hi - s_lo, name) for name, s_lo, s_hi in self.spans
                      if s_lo <= mid < s_hi]
            label = min(inside)[1] if inside else "loop gap"
            out.append([label, length * 1e-6])
        return out

    def op_calls(self, name: str) -> list[tuple[list, float]]:
        """``[(input_shapes, device_us), ...]`` of operator ``name``."""
        return self.ops.get(name, [])

    def nccl_exposed_us(self) -> float:
        nccl = [(lo, hi) for name, lo, hi in self.kernels if "nccl" in name.lower()]
        other = [(lo, hi) for name, lo, hi in self.kernels if "nccl" not in name.lower()]
        return arith.uncovered_us(nccl, other)
