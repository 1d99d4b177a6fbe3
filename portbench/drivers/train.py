"""Window driver of a training stage: the trainer's own loop, as the CLI
runs it (``config_from_args`` of the CLI named by the traffic, then the
trainer's ``run_pretraining``), over the benchmark's corpus and weights.

The driver reaches into the trainer's module only through the names it
imports, each replaced for the run by a wrapper of the original:

- the model class: the program builds its model, then takes the
  benchmark's weights (``portbench/weights.py``);
- the step factory: the step it returns is wrapped so that the benchmark
  sees every call: it keeps the readings of the first ``checked_steps``
  (losses, the momentum buffers after one step, each leaf's change after
  them), warms up, times ``calibration_steps`` to choose the window's step
  count (the ranks take the largest, in one collective), then opens the
  window on a device synchronisation, and closes it on one at the call
  after its last step, ending the stage there (:class:`WindowClosed`);
- ``DataLoader`` and ``MetricsPipe``: subclasses that record the loader
  wait and the metric read as spans.

The window holds whole iterations of the loop: each step's call and the
loop's work until the next call (the loader, the lag-1 metric read, the
CSV row).  A traced run (``--trace 1``) runs the same window untraced, then
``trace_steps`` steps under a profile of the device alone and
``trace_steps`` under one of the host's operators too
(:mod:`portbench.trace`).
"""

from __future__ import annotations

import gc
import importlib
import time

import torch

from portbench import weights as bench_weights
from portbench.trace import Spans, TraceView, start_device_trace, start_op_trace


class WindowClosed(Exception):
    """Raised inside the trainer's loop when the window has closed."""


def _apply(obj, values: dict) -> None:
    for k, v in values.items():
        if not hasattr(obj, k):
            raise KeyError(f"{type(obj).__name__} has no field {k!r}")
        old = getattr(obj, k)
        setattr(obj, k, tuple(v) if isinstance(old, tuple) else v)


def train_config(ctx) -> object:
    """The program's ``TrainConfig``: the CLI's parse of the run's flags,
    then every field the configuration file and the traffic's ``data``
    state, set as they say."""
    t, c = ctx.traffic, ctx.config
    cli = importlib.import_module(t["program"]["cli"])
    argv = ["-train_group", t["corpus"]["group"], "-jpg_root", ctx.corpus["jpg"],
            "--pack_root", ctx.corpus["pack"], "-savedir", str(ctx.out_dir / "stage"),
            "--run_id", "portbench_1_g0_default_0_0", "--seed", str(ctx.seed),
            "--batch_size", str(t["batch_per_chip"]), "--n_trainsamples",
            str(t["n_trainsamples"]), "--n_epoch", str(t["n_epoch"]),
            "--num_workers", str(t["num_workers"]), *t.get("cli_args", [])]
    if t.get("mesh"):
        argv += ["--mesh", t["mesh"]]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    _apply(cfg.model, c["model"])
    _apply(cfg.mask, c["mask"])
    _apply(cfg.optim, {k: v for k, v in c["optim"].items()})
    _apply(cfg.data, {**t.get("data", {}), "num_frames": cfg.model.num_frames,
                      "tubelet_size": cfg.model.tubelet_size,
                      "image_size": cfg.model.image_size})
    return cfg


class StageWindow:
    """The wrapped step's bookkeeping (see the module's docstring)."""

    def __init__(self, ctx, batch_rows: int):
        t = ctx.traffic
        self.ctx = ctx
        self.checked = t["checked_steps"]
        self.warmup = max(t["warmup_steps"], self.checked + 1)
        self.calib = t["calibration_steps"]
        self.spans = Spans()
        self.batch_rows = batch_rows
        self.calls = 0
        self.open_at = self.warmup + self.calib + 1  # the window's first call
        self.n = 0  # the window's steps, known once calibrated
        self.losses: list = []
        self.snap = self.target_snap = None
        self.g1 = self.d3 = self.t3 = None
        self.names: list[str] = []
        self.target_names: list[str] = []
        self.calls_t: list[tuple[float, float]] = []
        self.metrics_out: list = []
        self.prof = None
        self.traced = 0  # steps traced after the window (``--trace 1``)
        self.result: dict = {}

    # -- readings of the checked steps ------------------------------------
    @torch.no_grad()
    def _snapshot(self, state) -> None:
        self.names = [n for n, _ in state.model.named_parameters()]
        self.snap = [p.detach().clone() for p in state.model.parameters()]
        if getattr(state, "target", None) is not None:
            self.target_names = [n for n, _ in state.target.named_parameters()]
            self.target_snap = [p.detach().clone() for p in state.target.parameters()]

    @torch.no_grad()
    def _first_gradient(self, state) -> None:
        bufs = [state.optimizer.state[p]["momentum_buffer"] for p in state.model.parameters()]
        self.g1 = torch.stack([b.float().norm() for b in bufs])

    @torch.no_grad()
    def _changes(self, state) -> None:
        self.d3 = torch.stack([(p.detach() - s).float().norm()
                               for p, s in zip(state.model.parameters(), self.snap)])
        if self.target_snap is not None:
            self.t3 = torch.stack([(p.detach() - s).float().norm()
                                   for p, s in zip(state.target.parameters(), self.target_snap)])
        self.snap = self.target_snap = None

    def readings(self) -> dict:
        out = {"loss": [float(x) for x in self.losses],
               "g1": dict(zip(self.names, self.g1.tolist())),
               "d3": dict(zip(self.names, self.d3.tolist()))}
        if self.t3 is not None:
            out["t3"] = dict(zip(self.target_names, self.t3.tolist()))
        return out

    # -- the window ---------------------------------------------------------
    def _sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _calibrate(self) -> None:
        self._sync()
        per_step = (time.perf_counter() - self.t_calib) / self.calib
        n = max(1, round(self.ctx.seconds / per_step))
        if torch.distributed.is_initialized():  # the ranks agree on the stopping step
            agreed = torch.tensor([n], device=self.ctx.device)
            torch.distributed.all_reduce(agreed, op=torch.distributed.ReduceOp.MAX)
            n = int(agreed.item())
        self.n = n
        self.traced = self.ctx.traffic["trace_steps"] if self.ctx.trace else 0

    def _open(self) -> None:
        self.ctx.mark("warm")
        if self.ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.ctx.device)
        self._sync()
        self.t_open = time.perf_counter()
        self.open_epoch = time.time()

    def _close(self) -> None:
        self._sync()
        t_close = time.perf_counter()
        dev = self.ctx.device
        self.result = {"window_s": t_close - self.t_open, "steps": self.n,
                       "clips": self.n * self.batch_rows,
                       "open_epoch": self.open_epoch,
                       "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                             if dev.type == "cuda" else 0),
                       "calls": list(self.calls_t),
                       "metrics_out": list(self.metrics_out)}
        self.metrics_out = []

    def _start_trace(self, phase: str) -> None:
        self._sync()
        self.t_trace = time.perf_counter()
        if phase == "device" and self.ctx.device.type == "cuda":
            self.prof, self.marker_s = start_device_trace(self.ctx.device)
            self.t_trace = self.marker_s
        else:
            self.prof, self.marker_s = start_op_trace(self.ctx.device), None
            self.spans.traced = True

    def _stop_trace(self, phase: str) -> None:
        self._sync()
        wall = time.perf_counter() - self.t_trace
        self.prof.__exit__(None, None, None)
        if self.marker_s is not None:
            view = TraceView(self.prof, wall, self.traced, self.spans.items, self.marker_s)
        else:
            view = TraceView(self.prof, wall, self.traced)
        self.result["trace" if phase == "device" else "op_trace"] = view
        self.result[f"{phase}_metrics_out"] = list(self.metrics_out)
        self.metrics_out = []
        self.prof = None

    def before(self, i: int, state) -> None:
        if i == 1:
            self._snapshot(state)
        elif i == 2:
            self._first_gradient(state)
        if i == self.checked + 1:
            self._changes(state)
        if i == self.warmup + 1:
            self._sync()
            self.t_calib = time.perf_counter()
        if i == self.open_at:
            self._calibrate()
            self._open()
        if not self.n:
            return
        end = self.open_at + self.n  # the call after the window's last step
        if i == end:
            self._close()
            if self.traced:
                self._start_trace("device")
        if self.traced and i == end + self.traced:
            self._stop_trace("device")
            self._start_trace("op")
        if i == end + 2 * self.traced:
            if self.traced:
                self._stop_trace("op")
            raise WindowClosed

    def after(self, i: int, out: dict, t0: float, t1: float) -> None:
        if i <= self.checked:
            self.losses.append(out["loss"].detach())
        if self.n and i >= self.open_at:
            if i < self.open_at + self.n:
                self.calls_t.append((t0, t1))
            self.metrics_out.append(out)

    def wrap(self, step):
        fault = self.ctx.fault

        def wrapped(state, batch, *args, **kw):
            self.calls += 1
            i = self.calls
            self.before(i, state)
            if fault is not None:
                batch = fault.batch(batch)
            t0 = time.perf_counter()
            with self.spans.span("step"):
                if fault is not None:
                    out = fault.call(step, state, batch, *args, **kw)
                else:
                    out = step(state, batch, *args, **kw)
            t1 = time.perf_counter()
            self.after(i, out, t0, t1)
            return out

        wrapped.eval_step = step.eval_step
        if hasattr(step, "comm_report"):
            wrapped.comm_report = step.comm_report
        if hasattr(step, "time_slice"):
            wrapped.time_slice = step.time_slice
        return wrapped


def _patch(module, name: str, new) -> callable:
    old = getattr(module, name)
    setattr(module, name, new)
    return lambda: setattr(module, name, old)


def run(ctx) -> dict:
    """Run the stage up to the window's close; returns this rank's window
    record, and on rank 0 the program's readings of the checked steps."""
    t = ctx.traffic
    trainer = importlib.import_module(t["program"]["trainer"])
    cfg = train_config(ctx)
    window = StageWindow(ctx, t["batch_per_chip"] * ctx.world)
    spans = window.spans
    model_cls = getattr(trainer, t["program"]["model_class"])
    factory = getattr(trainer, t["program"]["step_factory"])

    def build_model(model_cfg, seed=0):
        model = model_cls(model_cfg, seed=seed)
        ctx.mark("program model")
        ctx.shapes = bench_weights.shapes_of(model)
        model.load_state_dict(bench_weights.make_weights(ctx.shapes, ctx.seed, ctx.device))
        ctx.mark("weights")
        return model

    def make_step(*args, **kw):
        return window.wrap(factory(*args, **kw))

    class Loader(trainer.DataLoader):
        def epoch(self, epoch):
            it = super().epoch(epoch)
            try:
                while True:
                    with spans.span("loader_wait"):
                        try:
                            batch = next(it)
                        except StopIteration:
                            return
                    yield batch
            finally:
                it.close()

    class Pipe(trainer.MetricsPipe):
        def push(self, *args, **kw):
            with spans.span("metric_read"):
                return super().push(*args, **kw)

    undo = [_patch(trainer, t["program"]["model_class"], build_model),
            _patch(trainer, t["program"]["step_factory"], make_step),
            _patch(trainer, "DataLoader", Loader), _patch(trainer, "MetricsPipe", Pipe)]
    try:
        trainer.run_pretraining(cfg, device=ctx.device)
    except WindowClosed:
        pass
    finally:
        for u in undo:
            u()
    if not window.result:
        raise RuntimeError(f"the stage ended after {window.calls} steps, before its window "
                           "closed: the traffic's epoch is too short")
    rec = dict(window.result)
    rec["readings"] = window.readings()
    for key in ("metrics_out", "device_metrics_out", "op_metrics_out"):
        rec[key] = [{k: float(v) for k, v in m.items()} for m in rec.get(key, [])]
    del window
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return rec
