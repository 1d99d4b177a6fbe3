"""The plain reference against the port's CPU path, at tiny widths: every
tiny cell's run is correct with the reference's limits for f32, and a port
that computes in bf16, one precision below, fails them; so does the
control, the reference itself in float8."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench.reference import compare, vit
from portbench.tests.cpu_run import run_on_cpu

CELLS = ["tiny.train", "tiny_jepa.train", "tiny.embed"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(root, cell):
    line = run_on_cpu(root, cell, seed=2**31 + 7)
    assert line["correct"], line["compared"]
    assert all(row["value"] < row["limit"] / 10 for row in line["compared"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_a_port_in_bf16_fails_the_f32_limits(root, tmp_path, cell):
    wl = json.loads((root / "BENCHMARK.json").read_text())
    cfg_name = next(w["config"] for w in wl["workloads"] if w["name"] == cell)
    path = root / "portbench" / "configs" / f"{cfg_name}.json"
    original = path.read_text()
    cfg = json.loads(original)
    cfg["model"]["dtype"] = "bfloat16"
    path.write_text(json.dumps(cfg))
    try:
        line = run_on_cpu(root, cell, seed=11)
    finally:
        path.write_text(original)
    assert not line["correct"], line["compared"]


@pytest.mark.parametrize("cell", ["tiny.train", "tiny_jepa.train"])
def test_the_float8_control_fails_the_limits(root, cell):
    """The reference in the program's place one precision down: float8
    operands in every product."""
    from portbench import corpus, weights
    from portbench import run as bench
    from portbench.drivers.train import train_config
    from portbench.reference.train import follow

    import importlib

    ctx = bench.Context(root, cell, 5, 0.1, False, torch.device("cpu"))
    t = ctx.traffic
    fam = importlib.import_module(f"portbench.reference.{ctx.config['reference']}")
    ctx.corpus, ctx.out_dir = {"jpg": "", "pack": ""}, root
    model = getattr(importlib.import_module(t["program"]["trainer"]),
                    t["program"]["model_class"])(train_config(ctx).model)
    params = weights.make_weights(weights.shapes_of(model), 5, "cpu")
    frames = corpus.write_corpus(root / f"control-{cell}", t["corpus"], 5, "cpu")
    runs = {kind: follow(fam.Trainer(ctx.config, t, frames, 5, "cpu", t["batch_per_chip"]),
                         params, t["batch_per_chip"], 3, 2, ctx.config["optim"],
                         vit.Precision(kind)) for kind in ("f32", "fp8")}
    correct, rows = compare.judged(compare.training_numbers(runs["fp8"], runs["f32"]),
                                   t["limits"])
    assert not correct, rows


def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the H100")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "vmae_b.embed.b64", "--seed", "2147483659", "--seconds", "3",
                          "--trace", "0"], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
