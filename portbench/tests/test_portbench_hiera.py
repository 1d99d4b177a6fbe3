"""The Hiera cell's benchmark files on the CPU, at a tiny size
(``portbench/tests/tiny_hiera.py``): its plain reference agrees with the
port; a port in bf16, the float8 control and the cell's faults (half the
batch, mask-unit attention made global, mean pools, the fusion heads left
out) fail the limits; the reference's masks are the program's sampler's;
the cell's three readers read a traced run, and find nothing to read where
the program has no such range or call."""

from __future__ import annotations

import importlib
import json
import math
import types

import numpy as np
import pytest
import torch

from portbench import arith, arith_hiera, manifest
from portbench.faults import FAULTS
from portbench.faults_hiera import HIERA_FAULTS
from portbench.reference import compare, hiera, vit
from portbench.tests.cpu_run import run_on_cpu
from portbench.tests.tiny_hiera import CELL, hiera_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return hiera_root(tmp_path_factory.mktemp("portbench_hiera"))


def test_the_manifest_holds_the_cell(root):
    from portbench.tests.conftest import REPO

    real = manifest.load(REPO)
    manifest.validate(real, REPO)
    assert manifest.workload(real, "hiera_h.train.b48")["chips"] == 1
    names = {m["name"] for m in manifest.cell_metrics(real, "hiera_h.train.b48", trace=True)}
    assert names == {"hiera_train_mfu", "mu_attn_device_ms.train", "flash32_roofline.train"}
    assert [m["name"] for m in manifest.cell_metrics(real, "hiera_h.train.b48", False)] == [
        "train_clips_per_s", "setup_s"]
    cfg = json.loads((REPO / "portbench/configs/hiera_h_mae.json").read_text())
    m = cfg["model"]
    assert cfg["reduced"] == [] and sum(m["stage_depths"]) == m["depth"] == 48
    assert [int(m["hidden_size"] * m["dim_mul"] ** s) for s in range(4)] == [256, 512, 1024, 2048]


def test_reference_agrees_with_the_port(root):
    line = run_on_cpu(root, CELL, seed=2**31 + 7)
    assert line["correct"], line["compared"]
    assert all(row["value"] < row["limit"] / 10 for row in line["compared"].values())


@pytest.mark.parametrize("fault", ["half_batch", "global_mu", "qpool_mean", "no_fusion"])
def test_a_broken_step_is_not_correct(root, fault):
    faults = {**FAULTS, **HIERA_FAULTS}
    line = run_on_cpu(root, CELL, seed=2**32 + 3, fault=faults[fault]())
    assert not line["correct"], line["compared"]


def test_a_port_in_bf16_fails_the_f32_limits(root):
    path = root / "portbench" / "configs" / "tiny_hiera.json"
    original = path.read_text()
    cfg = json.loads(original)
    cfg["model"]["dtype"] = "bfloat16"
    path.write_text(json.dumps(cfg))
    try:
        line = run_on_cpu(root, CELL, seed=11)
    finally:
        path.write_text(original)
    assert not line["correct"], line["compared"]


def test_the_float8_control_fails_the_limits(root):
    from portbench import corpus, weights
    from portbench import run as bench
    from portbench.drivers.train import train_config
    from portbench.reference.train import follow

    ctx = bench.Context(root, CELL, 5, 0.1, False, torch.device("cpu"))
    t = ctx.traffic
    fam = importlib.import_module(f"portbench.reference.{ctx.config['reference']}")
    ctx.corpus, ctx.out_dir = {"jpg": "", "pack": ""}, root
    model = getattr(importlib.import_module(t["program"]["trainer"]),
                    t["program"]["model_class"])(train_config(ctx).model)
    params = weights.make_weights(weights.shapes_of(model), 5, "cpu")
    frames = corpus.write_corpus(root / "control-hiera", t["corpus"], 5, "cpu")
    runs = {kind: follow(fam.Trainer(ctx.config, t, frames, 5, "cpu", t["batch_per_chip"]),
                         params, t["batch_per_chip"], 3, 2, ctx.config["optim"],
                         vit.Precision(kind)) for kind in ("f32", "fp8")}
    correct, rows = compare.judged(compare.training_numbers(runs["fp8"], runs["f32"]),
                                   t["limits"])
    assert not correct, rows


@pytest.mark.parametrize("ratio,units", [(0.9, (8, 7, 7)), (0.5, (2, 2, 2))])
def test_reference_masks_are_the_programs_sampler(ratio, units):
    from bvc_tpu_torch.masks.tube import mask_unit_mask

    for seed in (3, 2**31 + 1):
        a = hiera.mask_unit_masked(torch.Generator().manual_seed(seed), 6, math.prod(units),
                                   ratio)
        b = mask_unit_mask(torch.Generator().manual_seed(seed), 6, units, ratio)
        assert torch.equal(a, b)


def _reader(name: str):
    from portbench.tests.conftest import REPO

    return manifest.load_module(manifest.metric_path(REPO, name), "m_" + name.replace(".", "_"))


def test_the_readers_on_a_traced_cpu_run(root):
    line = run_on_cpu(root, CELL, seed=9, trace=True)
    metrics = line["metrics"]
    assert metrics["hiera_train_mfu"]["value"] > 0
    # no device time on the CPU: the device readers find nothing to read
    assert "mu_attn_device_ms.train" not in metrics and "flash32_roofline.train" not in metrics


def _view(calls: dict, steps: int = 2):
    trace = types.SimpleNamespace(steps=steps, op_calls=lambda op: calls.get(op, []))
    return types.SimpleNamespace(window={"op_trace": trace})


def test_the_device_readers_arithmetic():
    fwd = [([[48, 1568, 16, 32], [48, 1568, 16, 32], [48, 1568, 16, 32], []], 2000.0),
           ([[48, 156, 16, 64], [48, 156, 16, 64], [48, 156, 16, 64], []], 50.0),  # d = 64
           ([[64, 199, 12, 32], [64, 199, 12, 32], [64, 199, 12, 32], [64, 199]], 70.0)]
    bwd = [([[48, 1568, 16, 32]] * 6 + [[]], 5000.0)]
    view = _view({"bvc_tpu_torch::flash_fwd": fwd, "bvc_tpu_torch::flash_bwd": bwd,
                  "bvc::mask_unit_attn": [([], 300.0), ([], 500.0)]})
    bound = (arith.attention_bound_ms(48, 1568, 16, 32)[0]
             + arith.bwd_bound_ms(48, 1568, 16, 32, 5, 3)[0])
    np.testing.assert_allclose(_reader("flash32_roofline.train").read(view),
                               100 * bound * 1e3 / 7000.0)
    np.testing.assert_allclose(_reader("mu_attn_device_ms.train").read(view), 800.0 / 1e3 / 2)
    # a program without the range or the d = 32 calls (the parent of this cell)
    for name in ("flash32_roofline.train", "mu_attn_device_ms.train"):
        assert _reader(name).read(_view({})) is None
        assert _reader(name).read(types.SimpleNamespace(window={})) is None


def test_the_step_count():
    from portbench.tests.conftest import REPO

    m = json.loads((REPO / "portbench/configs/hiera_h_mae.json").read_text())["model"]
    assert arith_hiera.kept_units(m, 0.9) == 39
    enc, tokens = arith_hiera.encoder_flops(m, 39)
    assert tokens == [2496, 624, 156, 156]
    # stage 1's first block: qkv 6 n d^2, 39 windows of 64 x 64 scores and
    # P.V, the projection and the MLP (24 n d^2 + 4 windows w^2 d in all)
    one = arith_hiera.encoder_flops({**m, "stage_depths": [1, 0, 0, 0]}, 39)[0]
    assert one == 24 * 2496 * 256 ** 2 + 4 * 39 * 64 * 64 * 256
    per_clip = arith_hiera.hiera_train_flops_per_clip(m, 0.9)
    assert 1.0e12 < per_clip < 1.2e12
    assert arith.PEAK_BF16_FLOPS == 989e12


def test_the_mfu_reader_finds_nothing_in_other_cells():
    view = types.SimpleNamespace(config={"mask": {"mask_ratio": 0.9}},
                                 model={"architecture": "base"}, window={})
    assert _reader("hiera_train_mfu").read(view) is None
