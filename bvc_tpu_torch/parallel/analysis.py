"""Communication accounting: the collectives a step really issues
(counterpart of :mod:`bvc_tpu.parallel.analysis`).

JAX reads a step's collectives out of its compiled HLO.  The port has no
HLO: a step issues its collectives eagerly through the process group, so
they are counted as they are issued.  :func:`record_collectives` notes each
collective this process issues while it is open, as a
:class:`CollectiveOp` of JAX's kinds (its payload bytes, its group's size,
where it came from, whether it ran inside a gradient-accumulation loop);
:class:`CommReport` aggregates them with JAX's methods and ``summary()``
keys, so a report of either package reads the same way.

Where the collectives come from, and what sees each:

- every collective function of ``torch.distributed`` that the port, FSDP2
  and ZeRO call through the package: the data and model collectives, the
  seq ring and the pipe hops (:class:`~bvc_tpu_torch.parallel.collectives.
  Exchange`, one ``batch_isend_irecv`` an exchange), the pipe step's
  bucketed all-reduces, FSDP2's all-gathers and reduce-scatters (and
  HSDP's all-reduce over ``model``), ZeRO's broadcasts of the parameters
  after ``step()``, DDP's broadcast of buffers before a forward, the
  checkpoints' gathers.  While a recording is open the package's attributes
  are wrappers that note the call and make it; outside one they are
  torch's own, so the recorder costs nothing.  Both names of a collective
  that torch renamed are wrapped (``all_gather_into_tensor`` /
  ``all_gather_single``, ``reduce_scatter_tensor`` /
  ``reduce_scatter_single``), since FSDP2 calls one or the other by
  version;
- DDP's gradient buckets, which its reducer all-reduces from C++, where
  no Python wrapper sees them: the first recording gives every live DDP
  (:func:`~bvc_tpu_torch.parallel.sharding.wrap_data_parallel` keeps a weak
  reference to each) a comm hook that issues the same all-reduce through
  the package (``default_hooks.allreduce_hook``), so the wrapper sees it,
  labelled with its bucket.  A DDP recorded once keeps that hook: one
  Python call a bucket;
- any other collective function of the package (``reduce``, ``gather``,
  ``scatter``, ...) raises :class:`UnrecordedCollective` while a recording
  is open: a report that misses traffic is what this module exists to
  catch.

Not seen: the functional collectives (``torch.distributed.
_functional_collectives``, DTensor's redistribution), which run as C++
operators (the port calls none on a step: ``sharding._gather_dim0`` stands
in for ``DTensor.full_tensor``), and the one broadcast of bucket indices
that DDP's reducer makes from C++ when it rebuilds its buckets after its
first step.  (In that first step DDP reduces every gradient in one bucket;
a report of a fresh DDP's first step shows that one.)

``in_loop``: an op issued while a non-final microbatch of a gradient
accumulation runs (:func:`in_accumulation`, which the steps'
``_sync_unless`` enters) runs once per microbatch, JAX's "inside the scan".
Gradient reductions must never be there; FSDP2's parameter gathers are, by
design (each microbatch gathers the parameters it uses).

Ring estimates per rank (the scaling-book model, as JAX's):

- all-reduce: ``2 (g - 1) / g`` payload;
- all-gather: ``(g - 1) / g`` payload (payload = the gathered tensor);
- reduce-scatter: ``(g - 1)`` payload (payload = the rank's shard);
- broadcast: ``(g - 1) / g`` payload (every rank but the root receives it
  once; averaged over the group);
- collective-permute: payload (one point-to-point send: the bytes the rank
  sends); all-to-all: payload.

Every step factory of the port gives its step a ``comm_report(state,
*batch)`` method (:func:`report_step`): the step run once under a recording
on the state, which is then restored bit for bit.
"""

from __future__ import annotations

import contextlib
import functools
import pickle
import sys
import threading
import weakref
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist

class UnrecordedCollective(RuntimeError):
    """A collective the recorder cannot account for was issued inside
    :func:`record_collectives`."""


@dataclass
class CollectiveOp:
    """One collective this process issued."""

    kind: str
    payload_bytes: int  # JAX's: the result (all-gather: gathered; reduce-scatter: the shard)
    group_size: int     # ranks of the group it ran over
    line: str = ""      # its source: "ddp bucket 3", "all_reduce from bvc_tpu_torch/..."
    computation: str = ""  # the recorded step's name
    in_loop: bool = False  # issued by a non-final microbatch: once per microbatch

    @property
    def ring_bytes_per_chip(self) -> float:
        """Estimated bytes each rank moves (module docstring)."""
        g = max(self.group_size, 1)
        if self.kind == "collective-permute":
            return float(self.payload_bytes)
        if g == 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2.0 * (g - 1) / g * self.payload_bytes
        if self.kind in ("all-gather", "broadcast"):
            return (g - 1) / g * self.payload_bytes
        if self.kind == "reduce-scatter":
            return float(g - 1) * self.payload_bytes
        return float(self.payload_bytes)


@dataclass
class CommReport:
    """Aggregated communication of one recorded step (JAX's methods and
    ``summary()`` keys)."""

    ops: list[CollectiveOp] = field(default_factory=list)

    @property
    def by_kind(self) -> dict[str, dict[str, float]]:
        out: dict[str, dict[str, float]] = {}
        for op in self.ops:
            d = out.setdefault(
                op.kind, {"count": 0, "payload_bytes": 0, "ring_bytes_per_chip": 0.0})
            d["count"] += 1
            d["payload_bytes"] += op.payload_bytes
            d["ring_bytes_per_chip"] += op.ring_bytes_per_chip
        return out

    @property
    def total_ring_bytes_per_chip(self) -> float:
        return sum(op.ring_bytes_per_chip for op in self.ops)

    def bytes_for(self, kind: str, min_payload: int = 0) -> int:
        return sum(op.payload_bytes for op in self.ops
                   if op.kind == kind and op.payload_bytes >= min_payload)

    def count_for(self, kind: str, min_payload: int = 0) -> int:
        return sum(1 for op in self.ops if op.kind == kind and op.payload_bytes >= min_payload)

    @property
    def loop_ops(self) -> list[CollectiveOp]:
        """Collectives issued by a non-final microbatch: they run once per
        microbatch (FSDP2's parameter gathers are among them by design)."""
        return [op for op in self.ops if op.in_loop]

    def summary(self) -> dict[str, Any]:
        return {
            "by_kind": self.by_kind,
            "total_payload_bytes": sum(op.payload_bytes for op in self.ops),
            "total_ring_bytes_per_chip": self.total_ring_bytes_per_chip,
            "loop_collectives": len(self.loop_ops),
            "loop_payload_bytes": sum(op.payload_bytes for op in self.loop_ops),
        }


def comm_report(x) -> CommReport:
    """The :class:`CommReport` of a recording (the list
    :func:`record_collectives` yields) or of any iterable of
    :class:`CollectiveOp`."""
    if isinstance(x, CommReport):
        return x
    if isinstance(x, (str, bytes)):
        raise TypeError("the port has no HLO: record the step's collectives with "
                        "record_collectives() and pass the recording")
    return CommReport(list(x))


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    import numpy as np

    return int(np.prod(t.shape, dtype=np.int64)) * np.dtype(t.dtype).itemsize


def _leaves(x) -> Iterator:
    if isinstance(x, torch.nn.Module):
        yield from (p for p in x.parameters() if p.requires_grad)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif hasattr(x, "__iter__") and not hasattr(x, "shape") and not isinstance(x, str):
        for v in x:
            yield from _leaves(v)
    elif hasattr(x, "shape") and hasattr(x, "dtype"):
        yield x


def tree_bytes(x) -> int:
    """Bytes of ``x``'s tensors (the gradient-volume yardstick): a module's
    trainable parameters (a ``DTensor`` counts whole), a state dict, an
    iterable of tensors, or a dict (nested) of numpy or JAX arrays."""
    return sum(_nbytes(t) for t in _leaves(x))


# ------------------------------------------------------------- recording


_lock = threading.Lock()
_open: list[tuple[list[CollectiveOp], str]] = []  # the open recordings, outermost first
_accumulating = [0]  # > 0 while a non-final microbatch runs
_label = threading.local()  # a source name set around a call (DDP's buckets)
_saved: dict[str, Callable] = {}  # the package's own functions while wrapped
_ddps: "weakref.WeakSet" = weakref.WeakSet()  # live DDP wrappers (wrap_data_parallel)
_HERE = Path(__file__).resolve()


def track_ddp(ddp) -> None:
    """Note a ``DistributedDataParallel`` so that a recording can see its
    buckets (a weak reference: nothing changes until one is opened)."""
    _ddps.add(ddp)
    if _open:
        _hook_ddps()


@contextlib.contextmanager
def in_accumulation():
    """Collectives issued inside are ``in_loop`` (a non-final microbatch)."""
    _accumulating[0] += 1
    try:
        yield
    finally:
        _accumulating[0] -= 1


def _source(name: str) -> str:
    label = getattr(_label, "value", None)
    if label:
        return label
    frame = sys._getframe(1)
    while frame is not None:
        path = Path(frame.f_code.co_filename)
        if path != _HERE and not path.name.startswith(("distributed_c10d", "c10d_logger")):
            parts = path.parts
            root = max((i for i, p in enumerate(parts) if p in ("bvc_tpu_torch", "torch")),
                       default=len(parts) - 1)
            caller = frame.f_back.f_code.co_qualname if frame.f_back is not None else ""
            return (f"{name} from {'/'.join(parts[root:])}:{frame.f_code.co_qualname}"
                    f" < {caller}")
        frame = frame.f_back
    return name


def _group_size(group) -> int:
    return dist.get_world_size(group if group is not None else dist.group.WORLD)


def _note(kind: str, payload: int, group, name: str) -> None:
    line = _source(name)
    size = _group_size(group)
    in_loop = _accumulating[0] > 0
    with _lock:
        for ops, computation in _open:
            ops.append(CollectiveOp(kind, int(payload), size, line, computation, in_loop))


def _arg(args, kwargs, i: int, name: str, default=None):
    return args[i] if len(args) > i else kwargs.get(name, default)


def _sum_bytes(tensors) -> int:
    return sum(_nbytes(t) for t in tensors)


# each recorded function: (kind, payload bytes, group) from its arguments
_RECORDED: dict[str, Callable] = {
    "all_reduce": lambda a, k: ("all-reduce", _nbytes(_arg(a, k, 0, "tensor")),
                                _arg(a, k, 2, "group")),
    "broadcast": lambda a, k: ("broadcast", _nbytes(_arg(a, k, 0, "tensor")),
                               _arg(a, k, 2, "group")),
    "_broadcast_coalesced": lambda a, k: ("broadcast", _sum_bytes(_arg(a, k, 1, "tensors")),
                                          _arg(a, k, 0, "process_group")),
    "all_gather": lambda a, k: ("all-gather", _sum_bytes(_arg(a, k, 0, "tensor_list")),
                                _arg(a, k, 2, "group")),
    "all_gather_into_tensor": lambda a, k: ("all-gather",
                                            _nbytes(_arg(a, k, 0, "output_tensor")),
                                            _arg(a, k, 2, "group")),
    "reduce_scatter": lambda a, k: ("reduce-scatter", _nbytes(_arg(a, k, 0, "output")),
                                    _arg(a, k, 3, "group")),
    "reduce_scatter_tensor": lambda a, k: ("reduce-scatter", _nbytes(_arg(a, k, 0, "output")),
                                           _arg(a, k, 3, "group")),
    "all_to_all": lambda a, k: ("all-to-all", _sum_bytes(_arg(a, k, 1, "input_tensor_list")),
                                _arg(a, k, 2, "group")),
    "all_to_all_single": lambda a, k: ("all-to-all", _nbytes(_arg(a, k, 1, "input")),
                                       _arg(a, k, 4, "group")),
    "send": lambda a, k: ("collective-permute", _nbytes(_arg(a, k, 0, "tensor")),
                          _arg(a, k, 2, "group")),
    "isend": lambda a, k: ("collective-permute", _nbytes(_arg(a, k, 0, "tensor")),
                           _arg(a, k, 2, "group")),
    # a barrier moves no payload; NCCL runs it as a one-element all-reduce
    "barrier": lambda a, k: ("all-reduce", 0, _arg(a, k, 0, "group")),
}
_RECORDED["all_gather_single"] = _RECORDED["all_gather_into_tensor"]
_RECORDED["_all_gather_base"] = _RECORDED["all_gather_into_tensor"]
_RECORDED["reduce_scatter_single"] = _RECORDED["reduce_scatter_tensor"]
_RECORDED["_reduce_scatter_base"] = _RECORDED["reduce_scatter_tensor"]
# recv and irecv, the receiving halves of a point-to-point send, pass
# unwrapped: the send is counted
_REFUSED = ("reduce", "gather", "scatter", "gather_object", "scatter_object_list",
            "broadcast_object_list", "send_object_list", "recv_object_list",
            "all_reduce_coalesced", "all_gather_coalesced", "monitored_barrier")


def _recording(name: str, fn: Callable) -> Callable:
    describe = _RECORDED[name]

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        kind, payload, group = describe(args, kwargs)
        _note(kind, payload, group, name)
        return fn(*args, **kwargs)

    return wrapper


def _refusing(name: str) -> Callable:
    def wrapper(*args, **kwargs):
        raise UnrecordedCollective(
            f"torch.distributed.{name} inside record_collectives(): the recorder does not "
            "account for it (bvc_tpu_torch/parallel/analysis.py)")

    return wrapper


def _all_gather_object(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def wrapper(object_list, obj, group=None):
        out = fn(object_list, obj, group)
        # payload: the gathered objects' pickles (what the ranks exchanged)
        _note("all-gather", sum(len(pickle.dumps(o)) for o in object_list), group,
              "all_gather_object")
        return out

    return wrapper


def _batch_isend_irecv(fn: Callable) -> Callable:
    isend = _saved["isend"]

    @functools.wraps(fn)
    def wrapper(p2p_op_list):
        for op in p2p_op_list:
            if op.op is isend:
                _note("collective-permute", _nbytes(op.tensor), op.group, "batch_isend_irecv")
        return fn(p2p_op_list)

    return wrapper


def _p2p_op(cls, originals: dict) -> Callable:
    """``P2POp`` taking the wrapped ``isend``/``irecv`` for torch's own
    (``P2POp`` checks its op against them)."""

    def make(op, *args, **kwargs):
        return cls(originals.get(op, op), *args, **kwargs)

    return make


def _ddp_hook(process_group, bucket):
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    _label.value = f"ddp bucket {bucket.index()}"
    try:
        return default_hooks.allreduce_hook(process_group, bucket)
    finally:
        _label.value = None


def _install() -> None:
    names = [*_RECORDED, "all_gather_object", "batch_isend_irecv", "P2POp", *_REFUSED]
    for name in names:
        if hasattr(dist, name):
            _saved[name] = getattr(dist, name)
    wrapped: dict[str, Callable] = {}
    for name in _RECORDED:
        if name in _saved:
            wrapped[name] = _recording(name, _saved[name])
    for name in _REFUSED:
        if name in _saved:
            wrapped[name] = _refusing(name)
    wrapped["all_gather_object"] = _all_gather_object(_saved["all_gather_object"])
    wrapped["batch_isend_irecv"] = _batch_isend_irecv(_saved["batch_isend_irecv"])
    wrapped["P2POp"] = _p2p_op(_saved["P2POp"], {wrapped["isend"]: _saved["isend"]})
    for name, fn in wrapped.items():
        setattr(dist, name, fn)
    _hook_ddps()


def _hook_ddps() -> None:
    for ddp in list(_ddps):
        # a DDP with a Python comm hook of its own issues its collectives
        # through the package already
        if not getattr(ddp, "_bvc_recorded", False) and not getattr(ddp, "_comm_hooks", None):
            ddp.register_comm_hook(ddp.process_group, _ddp_hook)
        ddp._bvc_recorded = True


def _uninstall() -> None:
    for name, fn in _saved.items():
        setattr(dist, name, fn)
    _saved.clear()


@contextlib.contextmanager
def record_collectives(computation: str = "") -> Iterator[list[CollectiveOp]]:
    """Note every collective this process issues while inside; yields the
    list they are appended to (in issue order), each stamped with
    ``computation``.  Recordings nest: an op goes to every open one."""
    ops: list[CollectiveOp] = []
    with _lock:
        first = not _open
        if first:
            _install()
        _open.append((ops, computation))
    try:
        yield ops
    finally:
        with _lock:
            _open[:] = [rec for rec in _open if rec[0] is not ops]
            if not _open:
                _uninstall()


# ------------------------------------------------------- a step's report


def _optimizers(opt) -> list:
    inner = getattr(opt, "optim", None)  # ZeRO's local optimizer
    return [opt] if inner is None else [opt, inner]


def _clone(v):
    return v.detach().clone() if isinstance(v, torch.Tensor) else v


def _modules(state) -> list[torch.nn.Module]:
    from bvc_tpu_torch.parallel.sharding import resharded

    return [resharded(m) for m in (state.model, state.target) if m is not None]


def _local(t: torch.Tensor) -> torch.Tensor:
    from bvc_tpu_torch.parallel.sharding import local_tensor

    return local_tensor(t)


def snapshot(state) -> dict:
    """Copies of what a step changes in ``state``: the parameters and
    buffers of the model and the target (each rank's parts), their
    gradients, the optimizers' state and hyperparameters, the step count
    and the generator's state."""
    mods = _modules(state)
    params = [p for m in mods for p in m.parameters()]
    return {
        "params": [_local(p).detach().clone() for p in params],
        "grads": [None if p.grad is None else p.grad.detach().clone() for p in params],
        "buffers": [b.detach().clone() for m in mods for b in m.buffers()],
        "optim": [({p: {k: _clone(v) for k, v in st.items()} for p, st in o.state.items()},
                   [{k: v for k, v in g.items() if k != "params"} for g in o.param_groups])
                  for o in _optimizers(state.optimizer)],
        "step": state.step, "generator": state.generator.get_state()}


@torch.no_grad()
def restore(state, saved: dict) -> None:
    """Put back what :func:`snapshot` copied."""
    mods = _modules(state)
    params = [p for m in mods for p in m.parameters()]
    for p, v, g in zip(params, saved["params"], saved["grads"]):
        _local(p).copy_(v)
        p.grad = g
    for b, v in zip([b for m in mods for b in m.buffers()], saved["buffers"]):
        b.copy_(v)
    for o, (st, groups) in zip(_optimizers(state.optimizer), saved["optim"]):
        o.state.clear()
        o.state.update(st)
        for g, hyper in zip(o.param_groups, groups):
            g.update(hyper)
    state.step = saved["step"]
    state.generator.set_state(saved["generator"])


def report_step(step: Callable, state, *args, **kwargs) -> CommReport:
    """The collectives of one ``step(state, *args, **kwargs)``: the step
    runs once under :func:`record_collectives`, stamped with its factory's
    name (``step.computation``), and ``state`` is then restored
    (parameters, buffers, gradients, optimizer state, step count,
    generator) bit for bit."""
    saved = snapshot(state)
    try:
        with record_collectives(getattr(step, "computation", "step")) as ops:
            step(state, *args, **kwargs)
    finally:
        restore(state, saved)
    return CommReport(ops)


def with_comm_report(step: Callable, computation: str | None = None) -> Callable:
    """``step`` with ``step.comm_report(state, *batch)``
    (:func:`report_step`), the counterpart of JAX's ``compiled_text``;
    ``computation`` names it in the report (its factory's name when
    None)."""
    step.computation = computation or step.__qualname__.split(".<locals>")[0]
    step.comm_report = functools.partial(report_step, step)
    return step
