"""The port's span log (``bvc_tpu_torch.utils.profiling``): nesting,
threads and the ring's bound; ``record_function`` ranges only under a
profiler; the spans of the loader, the VideoMAE and JEPA steps, the
extraction entry and the trainer loop; ``--profile_dir``'s summary by span;
and the benchmark's clock match (``portbench/program_spans.py``), which puts
the log on a profile's clock."""

import copy
import json
import threading

import numpy as np
import pytest
import torch

from bvc_tpu_torch.data.loader import DataLoader
from bvc_tpu_torch.evalbench.extract import untrained_embed_fn
from bvc_tpu_torch.masks.multiblock import mask_collate
from bvc_tpu_torch.models.jepa import JEPA
from bvc_tpu_torch.models.videomae import VideoMAEPretrain
from bvc_tpu_torch.training import trainer_videomae
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_jepa_train_step, make_videomae_train_step
from bvc_tpu_torch.utils import profiling
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig, TrainConfig
from bvc_tpu_torch.utils.profiling import profiler_range, span
from portbench import program_spans
from portbench.trace import Spans, TraceView, start_op_trace
from torch_tiny_runs import tiny_cfg

VIDEOMAE = dict(image_size=32, patch_size=8, num_frames=4, tubelet_size=2, hidden_size=32,
                depth=1, num_heads=2, mlp_ratio=2.0, decoder_hidden_size=16, decoder_depth=1,
                decoder_num_heads=2, dtype="float32")
JEPA_TINY = dict(family="jepa", image_size=32, patch_size=8, num_frames=2, tubelet_size=1,
                 hidden_size=32, depth=1, num_heads=2, mlp_ratio=2.0, pred_depth=1,
                 pred_emb_dim=16, dtype="float32")
OPTIM = dict(name="sgd", lr=0.05, momentum=0.9, nesterov=True, weight_decay=1e-4)
PHASES = ["step.inputs", "step.forward", "step.backward", "step.update", "step.metrics"]


def _mark() -> int:
    return max((r["id"] for r in profiling.spans()), default=0)


def _since(mark: int, thread: int | None = None) -> list[dict]:
    return [r for r in profiling.spans()
            if r["id"] > mark and (thread is None or r["thread"] == thread)]


def _children(recs: list[dict], parent: dict) -> list[str]:
    return [r["name"] for r in sorted(recs, key=lambda r: r["t0"]) if r["parent"] == parent["id"]]


def test_spans_nest_with_parents_on_their_own_thread():
    mark = _mark()
    seen = {}

    def other():
        with span("b.outer"):
            with span("b.inner"):
                seen["thread"] = threading.get_ident()

    with span("a.outer") as outer:
        with span("a.inner") as inner:
            t = threading.Thread(target=other)
            t.start()
            t.join(10)
        assert not t.is_alive()
    me = threading.get_ident()
    recs = {r["name"]: r for r in _since(mark) if r["thread"] in (me, seen["thread"])}
    assert set(recs) == {"a.outer", "a.inner", "b.outer", "b.inner"}
    assert recs["a.outer"]["parent"] == 0 and recs["a.inner"]["parent"] == outer.id
    assert recs["a.inner"]["id"] == inner.id and recs["a.outer"]["thread"] == me
    # the other thread's spans nest among themselves, not under this thread's
    assert recs["b.outer"]["parent"] == 0
    assert recs["b.inner"]["parent"] == recs["b.outer"]["id"]
    assert recs["b.inner"]["thread"] == seen["thread"] != me
    assert recs["a.outer"]["t0"] <= recs["a.inner"]["t0"] <= recs["b.outer"]["t0"]
    assert recs["b.outer"]["t1"] <= recs["a.inner"]["t1"] <= recs["a.outer"]["t1"]
    assert len({r["id"] for r in recs.values()}) == 4


def test_a_span_is_recorded_when_its_block_raises():
    mark = _mark()
    with pytest.raises(ValueError):
        with span("raises"):
            raise ValueError("inside")
    with span("after") as after:
        pass
    recs = _since(mark, threading.get_ident())
    assert [r["name"] for r in recs] == ["raises", "after"]
    assert after.parent == 0  # the raising span left the stack


def test_the_ring_keeps_only_the_last_spans():
    mark = _mark()
    for _ in range(profiling.RING_SIZE + 10):
        with span("fill"):
            pass
    recs = profiling.spans()
    assert len(recs) == profiling.RING_SIZE
    assert recs[-1]["name"] == "fill" and recs[-1]["thread"] == threading.get_ident()
    assert min(r["id"] for r in recs) > mark + 10  # the first ten went out of the ring


def _bvc_events(prof) -> list[str]:
    return sorted(e.name for e in prof.events() if e.name.startswith(profiling.PREFIX))


def test_ranges_under_a_cpu_profiler():
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(4, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            with profiler_range("inner"):
                torch.nn.functional.gelu(x)
    assert _bvc_events(prof) == ["bvc::inner", "bvc::outer"]


def test_no_ranges_without_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    assert not torch.autograd.profiler._is_profiler_enabled
    rng = profiler_range("inner")
    assert rng is profiler_range("other")  # one shared no-op context
    with span("outer") as s, rng:
        pass
    assert s._range is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(2) + 1
    assert _bvc_events(prof) == []


class _Clips:
    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, key):
        idx, _ = key
        return np.full((2, 3), idx, np.uint8)


def test_one_loader_wait_per_served_batch():
    loader = DataLoader(_Clips(12), global_batch_size=3, shuffle=False, num_workers=2,
                        to_device=False, collate_fn=lambda b, epoch, i: b + 1)
    me = threading.get_ident()
    mark = _mark()
    served = [len(list(loader.epoch(e))) for e in range(2)]
    assert served == [4, 4]
    recs = _since(mark)
    waits = [r for r in recs if r["name"] == "loader.wait"]
    assert len(waits) == loader.batches_served == 8
    assert all(r["thread"] == me and r["parent"] == 0 for r in waits)
    assert loader.wait_s == pytest.approx(sum(r["t1"] - r["t0"] for r in waits), rel=1e-9)
    last = [r["t1"] - r["t0"] for r in waits[-3:]]  # the last epoch's batches after its first
    assert loader.stall_ms == pytest.approx(sum(last) * 1e3 / 3, rel=1e-9)
    assembled = [r for r in recs if r["name"] == "loader.assemble"]
    collated = [r for r in recs if r["name"] == "loader.collate"]
    assert len(assembled) == len(collated) == 8
    assert {r["parent"] for r in collated} == {r["id"] for r in assembled}
    assert all(r["thread"] != me for r in assembled)


def _videomae_step(grad_accum: int):
    torch.manual_seed(0)
    state = TrainState.create(VideoMAEPretrain(ModelConfig(**VIDEOMAE)), OptimConfig(**OPTIM),
                              device="cpu")
    step = make_videomae_train_step(ModelConfig(**VIDEOMAE),
                                    MaskConfig(sampler="tube", mask_ratio=0.75),
                                    grad_accum=grad_accum)
    video = torch.randint(0, 256, (4, 4, 32, 32, 3), dtype=torch.uint8)
    return lambda: step(state, video)


def _jepa_step(grad_accum: int):
    torch.manual_seed(0)
    model = JEPA(ModelConfig(**JEPA_TINY))
    state = TrainState.create(model, OptimConfig(**OPTIM, exclude_bias_and_norm_from_wd=True),
                              device="cpu", target=copy.deepcopy(model.encoder))
    step = make_jepa_train_step(ModelConfig(**JEPA_TINY), 100, grad_accum=grad_accum)
    mask = MaskConfig(enc_mask_scale=(0.85, 1.0), pred_mask_scale=(0.2, 0.25),
                      num_pred_masks=2, min_keep=2)
    batch = {"video": np.random.default_rng(0).integers(0, 256, (4, 2, 32, 32, 3), np.uint8),
             **mask_collate(ModelConfig(**JEPA_TINY), mask, seed=0)(4, step=0)}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return lambda: step(state, batch)


@pytest.mark.parametrize("family,grad_accum", [("videomae", 1), ("videomae", 2), ("jepa", 1)])
def test_step_phases_in_order_inside_the_trainer_step(family, grad_accum):
    run = (_videomae_step if family == "videomae" else _jepa_step)(grad_accum)
    mark = _mark()
    with span("trainer.step") as outer:
        metrics = run()
    assert torch.isfinite(metrics["loss"])
    recs = _since(mark, threading.get_ident())
    top = next(r for r in recs if r["id"] == outer.id)
    micro = ["step.forward", "step.backward"] * grad_accum
    assert _children(recs, top) == ["step.inputs", *micro, "step.update", "step.metrics"]
    for r in recs:
        if r["parent"] == top["id"]:
            assert top["t0"] <= r["t0"] <= r["t1"] <= top["t1"]


def test_extract_call_holds_its_phases():
    fn = untrained_embed_fn("videomae", ModelConfig(**VIDEOMAE), device="cpu")
    clips = np.random.default_rng(0).integers(0, 256, (2, 4, 32, 32, 3), np.uint8)
    mark = _mark()
    out = fn(clips)
    assert out.shape == (2, 32)
    recs = _since(mark)
    call = next(r for r in recs if r["name"] == "extract.call")
    assert call["parent"] == 0
    assert _children(recs, call) == ["extract.h2d", "extract.forward", "extract.d2h"]


def test_the_clock_match_recovers_a_known_offset():
    """The benchmark saw only the last 12 of 40 program spans, on a clock
    1234.5678 s ahead; its spans start 20 µs later and end within 0.4 µs of
    the program's (its bookkeeping)."""
    rng = np.random.default_rng(3)
    off_us = 1234.5678e6
    t, prog, bench = 100.0, [], []
    for i in range(40):
        length = 0.25 + rng.uniform(-0.02, 0.02)
        prog.append((t, t + length))
        if i >= 28:
            bench.append((t * 1e6 + off_us + 20.0,
                          (t + length) * 1e6 + off_us + rng.uniform(-0.4, 0.4)))
        t += length + rng.uniform(0.001, 0.004)
    assert abs(program_spans.clock_offset_us(prog, bench) - off_us) < 1.0
    assert program_spans.clock_offset_us(prog, []) is None


class _View:
    def __init__(self, trace):
        self.trace, self.window = trace, {}


def test_placed_spans_agree_with_the_profilers_own_times():
    """In a CPU profile of five extraction calls inside the benchmark's
    ``call`` spans, the log's spans put on the profile's clock by the match
    lie within 50 µs of the profiler's ``bvc::`` ranges: each end's median
    over the calls (one call can be preempted between the two clocks'
    reads)."""
    fn = untrained_embed_fn("videomae", ModelConfig(**VIDEOMAE), device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # no idle pool threads spinning beside the host's clock reads
    try:
        _placed_against_profile(fn, calls=5)
    finally:
        torch.set_num_threads(threads)


def _placed_against_profile(fn, calls: int):
    clips = np.random.default_rng(0).integers(0, 256, (2, 4, 32, 32, 3), np.uint8)
    fn(clips)
    host = Spans(traced=True)
    mark = _mark()
    prof = start_op_trace(torch.device("cpu"))
    for _ in range(calls):
        with host.span("call"):
            fn(clips)
    prof.__exit__(None, None, None)
    view = _View(TraceView(prof, 1.0, calls))
    assert [name for name, _, _ in view.trace.spans] == ["call"] * calls
    placed = [s for s in program_spans.placed(view, view.trace) if s["id"] > mark]
    for name in ("extract.call", "extract.h2d", "extract.forward", "extract.d2h"):
        ours = sorted((s["lo"], s["hi"]) for s in placed if s["name"] == name)
        theirs = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                        if e.name == profiling.PREFIX + name)
        assert len(ours) == len(theirs) == calls, name
        starts = np.median([a[0] - b[0] for a, b in zip(ours, theirs)])
        ends = np.median([a[1] - b[1] for a, b in zip(ours, theirs)])
        assert abs(starts) < 50 and abs(ends) < 50, (name, starts, ends)


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    def __init__(self, name, device, start, end, thread=1, annotation=False):
        self.name, self.thread, self.is_user_annotation = name, thread, annotation
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)
        self.time_range = _Range(start, end)


def test_profile_idle_goes_to_the_innermost_span_on_the_loops_thread():
    """Kernels busy 0-10, 20-30, 31-40 and 60-70 µs: gaps of 10, 1 and 20
    µs.  The log is placed by its ``step.forward`` against the profile's
    range (the profile's clock 1 s behind); a range's mirror on the device
    and a loader thread's span change nothing."""
    p = profiling.PREFIX
    events = [_Event("k", True, 0, 10), _Event("k", True, 20, 30), _Event("k", True, 31, 40),
              _Event("Memcpy HtoD", True, 40, 60), _Event("k", True, 60, 70),
              _Event(p + "step.forward", False, 5, 25),
              _Event(p + "step.forward", True, 5, 25, annotation=True)]
    recs = [{"name": "trainer.step", "id": 1, "parent": 0, "thread": 7, "t0": 1.0,
             "t1": 1.000035},
            {"name": "step.forward", "id": 2, "parent": 1, "thread": 7, "t0": 1.000005,
             "t1": 1.000025},
            {"name": "loader.assemble", "id": 3, "parent": 0, "thread": 8, "t0": 1.000001,
             "t1": 1.000070}]
    assert profiling.busy_us(events) == (39.0, 20.0)
    idle = profiling.idle_ms_by_span(events, recs)
    assert idle == pytest.approx({"step.forward": 0.010, "trainer.step": 0.001,
                                  profiling.OUTSIDE: 0.020})
    assert profiling.idle_ms_by_span(events, recs[2:]) == {}  # nothing to place the log by


class _FakeTrace:
    def __init__(self, kernels, spans, steps=1):
        self.kernels = [("k", lo, hi) for lo, hi in kernels]
        self.spans, self.steps = spans, steps


def test_the_benchmarks_idle_attribution_is_complete(monkeypatch):
    """Every gap goes to one span or to "outside any span"; a gap counts
    toward each name on its span's chain of ancestors."""
    log = [{"name": "trainer.step", "id": 1, "parent": 0, "thread": 7, "t0": 1.0, "t1": 1.000050},
           {"name": "step.forward", "id": 2, "parent": 1, "thread": 7, "t0": 1.000005,
            "t1": 1.000025},
           {"name": "step.backward", "id": 3, "parent": 1, "thread": 7, "t0": 1.000025,
            "t1": 1.000045},
           {"name": "loader.assemble", "id": 4, "parent": 0, "thread": 8, "t0": 1.0,
            "t1": 1.000100}]
    monkeypatch.setattr(profiling, "spans", lambda: copy.deepcopy(log))
    # on the benchmark's clock the program's spans sit 1000501 µs earlier
    trace = _FakeTrace([(-500, -490), (-480, -470), (-465, -460), (-430, -400)],
                       [("step", -500, -451)])
    att = program_spans.idle_attribution(_View(trace))
    assert att["gaps"] == 3 and att["total_us"] == pytest.approx(10 + 5 + 30)
    assert att["innermost"] == pytest.approx({"step.forward": 10, "step.backward": 5,
                                              program_spans.OUTSIDE: 30})
    assert sum(att["innermost"].values()) == pytest.approx(att["total_us"])
    assert att["within"]["trainer.step"] == pytest.approx(15)
    assert program_spans.idle_ms(_View(trace), "step.forward") == pytest.approx(0.010)
    monkeypatch.delattr(profiling, "spans")  # a program without the log
    assert program_spans.idle_ms(_View(trace), "step.forward") is None


@pytest.fixture(scope="module")
def traced_stage(frame_corpus, tmp_path_factory):
    """A 3-step VideoMAE stage with ``--profile_dir``, the spans it logged."""
    tmp = tmp_path_factory.mktemp("stage")
    cfg = tiny_cfg(TrainConfig, "videomae", frame_corpus, tmp, "dev_1_g0_default_0_0",
                   batch_size=4)
    cfg.profile_dir = str(tmp / "prof")
    mark = _mark()
    trainer_videomae.run_pretraining(cfg, device="cpu")
    return _since(mark, threading.get_ident()), tmp / "prof"


def test_the_trainer_loop_logs_each_step_and_its_metric_read(traced_stage):
    recs, _ = traced_stage
    names = [r["name"] for r in sorted(recs, key=lambda r: r["t0"]) if r["parent"] == 0]
    assert names == ["loader.wait", "trainer.step", "trainer.metrics"] * 3
    for top in (r for r in recs if r["name"] == "trainer.step"):
        assert _children(recs, top) == PHASES


def test_profile_dir_summary_has_host_and_idle_time_by_span(traced_stage):
    _, prof = traced_stage
    summary = json.loads((prof / "summary.json").read_text())
    assert summary["steps"] == 2
    host = summary["host_ms_by_span"]
    assert set(PHASES) | {"trainer.step", "trainer.metrics", "loader.wait"} <= set(host)
    assert all(v >= 0 for v in host.values())
    assert summary["idle_ms_by_span"] == {}  # no kernels on the CPU
    names = {e["name"] for e in json.loads((prof / "trace.json").read_text())["traceEvents"]}
    assert {"bvc::trainer.metrics", "bvc::step.forward", "bvc::layer_norm", "bvc::gelu"} <= names
    assert "bvc::trainer.step" not in names  # a caller may trace from inside the step
