"""The readers of the program's span log (``portbench/program_spans.py``)
on the tiny CPU cells: the host-span metrics come back with ``--trace 1``,
agree with the benchmark's own spans, and the device's are left out (no
kernels on the CPU); every new reader returns nothing, without raising,
where the program keeps no span log."""

from __future__ import annotations

import pytest

from portbench import manifest
from portbench.tests.cpu_run import run_on_cpu

HOST = ("loader_wait_ms.train", "fwd_host_ms.train", "bwd_host_ms.train",
        "update_host_ms.train")
DEVICE_TRAIN = ("idle_fwd_ms.train", "idle_bwd_ms.train", "idle_update_ms.train")
DEVICE_EMBED = ("idle_h2d_ms.embed", "gelu_device_ms.embed", "layernorm_device_ms.embed")


@pytest.mark.parametrize("cell", ["tiny.train", "tiny_jepa.train"])
def test_host_span_metrics_of_a_traced_training_run(root, cell):
    line = run_on_cpu(root, cell, seed=2**31 + 7, trace=True, seconds=0.5)
    assert line["correct"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert all(m.get(k, -1) >= 0 for k in HOST[1:]), m
    # the loader's wait is read between two window steps, as the loop's gap
    assert ("loader_wait_ms.train" in m) == ("loop_gap_ms.train" in m)
    assert not set(DEVICE_TRAIN) & set(m)
    assert m["fwd_host_ms.train"] + m["bwd_host_ms.train"] + m["update_host_ms.train"] \
        <= m["dispatch_ms.train"]
    assert m.get("loader_wait_ms.train", 0) <= m.get("loop_gap_ms.train", 0)


def test_device_metrics_of_a_traced_extraction_run_are_left_out(root):
    line = run_on_cpu(root, "tiny.embed", seed=2**31 + 7, trace=True, seconds=0.5)
    assert line["correct"]
    assert not set(DEVICE_EMBED) & set(line["metrics"])


class _View:
    def __init__(self):
        self.window = {"calls": [(1.0, 1.1), (1.2, 1.3)], "op_trace": None}
        self.trace = None


def test_every_new_reader_returns_nothing_without_the_span_log(root, monkeypatch):
    from bvc_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    for name in HOST + DEVICE_TRAIN + DEVICE_EMBED:
        reader = manifest.load_module(manifest.metric_path(root, name), "t_" + name)
        assert reader.read(_View()) is None, name
