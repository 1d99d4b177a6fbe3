"""The program's own spans, as the per-layer metrics read them.

The program keeps a span log: an in-memory ring of its last spans, each
``{name, id, parent, thread, t0, t1}`` on ``time.perf_counter()`` seconds,
the clock of the window's ``calls``.  This module reaches it only through
``bvc_tpu_torch.utils.profiling.spans()``; where the program has no such
log, every function here returns ``None`` (or nothing) and raises nothing.

- host time: the window's spans of one name, picked by the window's
  ``calls`` (a step's phases lie inside its call; the loader's wait between
  two calls);
- the clock match: the program's ``trainer.step`` (or ``extract.call``)
  spans are matched by order to the benchmark's ``step`` (``call``) spans
  of a :class:`~portbench.trace.TraceView`, their ends aligned (only the
  benchmark's bookkeeping separates them); the median offset of the
  matching puts the program's spans on the trace's clock;
- idle attribution: each interval of the trace in which no kernel ran
  (between two merged kernel intervals, as ``TraceView.idle_gaps`` takes
  them) goes to the innermost program span on the loop's thread that holds
  its middle, or to ``OUTSIDE``; a gap counts toward a span name when that
  span or one of its ancestors has the name.
"""

from __future__ import annotations

import bisect
import collections
import statistics

from portbench import arith

ANCHORS = (("trainer.step", "step"), ("extract.call", "call"))  # (program, benchmark)
OUTSIDE = "outside any span"


def ring() -> list[dict] | None:
    """A copy of the program's span log; ``None`` where it keeps none."""
    try:
        from bvc_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return read() if callable(read) else None


def _named(view, name: str) -> list[dict] | None:
    recs = _cached(view, "ring", ring)
    if not recs:
        return None
    return [r for r in recs if r["name"] == name]


def _cached(view, key: str, make):
    cache = view.__dict__.setdefault("_program_spans", {})
    if key not in cache:
        cache[key] = make()
    return cache[key]


def _inside_ms(recs: list[dict], intervals: list[tuple[float, float]]) -> float:
    """Milliseconds of the spans whose start lies in one of ``intervals``
    (sorted, disjoint)."""
    starts = [lo for lo, _ in intervals]
    total = 0.0
    for r in recs:
        k = bisect.bisect_right(starts, r["t0"]) - 1
        if k >= 0 and r["t0"] < intervals[k][1]:
            total += r["t1"] - r["t0"]
    return total * 1e3


def step_ms(view, name: str) -> float | None:
    """Host ms a window step in the program's spans ``name`` that begin
    inside one of the window's calls."""
    calls = view.window.get("calls") or []
    recs = _named(view, name)
    if not calls or not recs:
        return None
    return _inside_ms(recs, sorted(calls)) / len(calls)


def gap_ms(view, name: str) -> float | None:
    """Host ms a window step in the program's spans ``name`` that begin
    between two of the window's calls, over the gaps between calls (as
    ``loop_gap_ms.train`` counts them)."""
    calls = sorted(view.window.get("calls") or [])
    recs = _named(view, name)
    gaps = [(a[1], b[0]) for a, b in zip(calls, calls[1:])]
    if not gaps or not recs:
        return None
    return _inside_ms(recs, gaps) / len(gaps)


def clock_offset_us(program: list[tuple[float, float]], bench: list[tuple[float, float]]
                    ) -> float | None:
    """Microseconds to add to the program's ``perf_counter`` seconds (times
    1e6) to put them on the clock of the benchmark's spans (``bench``, in
    µs): the program's spans are matched in order to the benchmark's,
    shifted by the whole number of spans whose ends agree best (the median
    distance of the offsets from their median, with the median difference
    of lengths), and the offset is the median of the matched ends'."""
    prog = sorted((lo * 1e6, hi * 1e6) for lo, hi in program)
    bench = sorted(bench)
    n = min(len(prog), len(bench))
    if not n:
        return None
    best = None
    for shift in range(len(bench) - n, len(prog) - n + 1):  # every full overlap
        pairs = [(b, prog[i + shift]) for i, b in enumerate(bench) if 0 <= i + shift < len(prog)]
        offsets = [b[1] - p[1] for b, p in pairs]
        mid = statistics.median(offsets)
        score = (statistics.median(abs(o - mid) for o in offsets)
                 + statistics.median(abs((b[1] - b[0]) - (p[1] - p[0])) for b, p in pairs))
        if best is None or score < best[0]:
            best = (score, mid)
    return best[1]


def placed(view, trace) -> list[dict] | None:
    """The program's spans on ``trace``'s clock (``lo``, ``hi`` in µs
    beside each record), or ``None`` without a span log, a trace, or a
    match."""
    recs = _cached(view, "ring", ring)
    if not recs or trace is None:
        return None
    for prog_name, bench_name in ANCHORS:
        anchors = [r for r in recs if r["name"] == prog_name]
        bench = [(lo, hi) for name, lo, hi in trace.spans if name == bench_name]
        if anchors and bench:
            off = clock_offset_us([(r["t0"], r["t1"]) for r in anchors], bench)
            loop = {r["thread"] for r in anchors}
            return [{**r, "lo": r["t0"] * 1e6 + off, "hi": r["t1"] * 1e6 + off,
                     "loop": r["thread"] in loop} for r in recs]
    return None


def idle_attribution(view, trace=None) -> dict | None:
    """``{"innermost": {name: µs}, "within": {name: µs}, "total_us",
    "gaps"}`` of ``trace`` (the device profile by default): each idle gap's
    µs under the innermost program span on the loop's thread at its middle
    (``OUTSIDE`` when none), and under every name on that span's chain of
    ancestors."""
    trace = view.trace if trace is None else trace
    if trace is None or not trace.kernels:
        return None
    return _cached(view, ("idle", id(trace)), lambda: _attribute(view, trace))


def _attribute(view, trace) -> dict | None:
    spans = placed(view, trace)
    if spans is None:
        return None
    busy = arith.merged((lo, hi) for _, lo, hi in trace.kernels)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    first, last = busy[0][0], busy[-1][1]
    loop = sorted((s for s in spans if s["loop"] and s["hi"] >= first and s["lo"] <= last),
                  key=lambda s: s["lo"])
    by_id = {s["id"]: s for s in spans}
    starts = [s["lo"] for s in loop]
    innermost: dict[str, float] = collections.defaultdict(float)
    within: dict[str, float] = collections.defaultdict(float)
    total = 0.0
    for lo, hi in gaps:
        mid, length = (lo + hi) / 2, hi - lo
        total += length
        k = bisect.bisect_right(starts, mid) - 1
        # spans of one thread nest: the latest start holding mid is the
        # innermost; past a root that does not hold it, none does
        while k >= 0 and not loop[k]["lo"] <= mid < loop[k]["hi"]:
            k = -1 if loop[k]["parent"] not in by_id else k - 1
        if k < 0:
            innermost[OUTSIDE] += length
            within[OUTSIDE] += length
            continue
        s = loop[k]
        innermost[s["name"]] += length
        names = set()
        while s is not None:
            names.add(s["name"])
            s = by_id.get(s["parent"])
        for name in names:
            within[name] += length
    return {"innermost": dict(innermost), "within": dict(within), "total_us": total,
            "gaps": len(gaps)}


def idle_ms(view, name: str) -> float | None:
    """Device idle ms a traced step (or call) with the program's loop
    thread inside span ``name``."""
    att = idle_attribution(view)
    if att is None:
        return None
    return att["within"].get(name, 0.0) / 1e3 / view.trace.steps
