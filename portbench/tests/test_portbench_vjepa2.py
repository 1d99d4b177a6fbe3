"""The V-JEPA 2 cell's benchmark files on the CPU, at a tiny size
(``portbench/tests/tiny_vjepa2.py``): its plain reference agrees with the
port; a port in bf16, the float8 control and the cell's faults (half the
batch, the rotations left out, the context rotated at ``0 .. Ke - 1``) fail
the limits; the reference's masks are the program's collator's; the
cell's three readers read a traced run, and find nothing to read without
the program's RoPE operator."""

from __future__ import annotations

import importlib
import json
import types

import numpy as np
import pytest
import torch

from portbench import arith, arith_rope, manifest
from portbench.faults import FAULTS
from portbench.faults_rope import ROPE_FAULTS
from portbench.reference import compare, masks3d, vit
from portbench.tests.cpu_run import run_on_cpu
from portbench.tests.tiny_vjepa2 import CELL, vjepa2_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return vjepa2_root(tmp_path_factory.mktemp("portbench_vjepa2"))


def test_the_manifest_holds_the_cell(root):
    from portbench.tests.conftest import REPO

    real = manifest.load(REPO)
    manifest.validate(real, REPO)
    assert manifest.workload(real, "vjepa2_g.train.b16")["chips"] == 1
    names = {m["name"] for m in manifest.cell_metrics(real, "vjepa2_g.train.b16", trace=True)}
    assert names == {"rope_device_ms.train", "rope_roofline.train", "vitg_train_mfu"}
    assert [m["name"] for m in manifest.cell_metrics(real, "vjepa2_g.train.b16", False)] == [
        "train_clips_per_s", "setup_s"]
    cfg = json.loads((REPO / "portbench/configs/vjepa2_vit_g.json").read_text())
    assert int(cfg["model"]["hidden_size"] * cfg["model"]["mlp_ratio"]) == 6144


def test_reference_agrees_with_the_port(root):
    line = run_on_cpu(root, CELL, seed=2**31 + 7)
    assert line["correct"], line["compared"]
    assert all(row["value"] < row["limit"] / 10 for row in line["compared"].values())


@pytest.mark.parametrize("fault", ["half_batch", "rope_off", "shifted_positions"])
def test_a_broken_step_is_not_correct(root, fault):
    faults = {**FAULTS, **ROPE_FAULTS}
    line = run_on_cpu(root, CELL, seed=2**32 + 3, fault=faults[fault]())
    assert not line["correct"], line["compared"]


def test_a_port_in_bf16_fails_the_f32_limits(root):
    path = root / "portbench" / "configs" / "tiny_vjepa2.json"
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
    frames = corpus.write_corpus(root / "control-vjepa2", t["corpus"], 5, "cpu")
    runs = {kind: follow(fam.Trainer(ctx.config, t, frames, 5, "cpu", t["batch_per_chip"]),
                         params, t["batch_per_chip"], 3, 2, ctx.config["optim"],
                         vit.Precision(kind)) for kind in ("f32", "fp8")}
    correct, rows = compare.judged(compare.training_numbers(runs["fp8"], runs["f32"]),
                                   t["limits"])
    assert not correct, rows


@pytest.mark.parametrize("grid,rows", [((8, 16, 16), 16), ((4, 4, 4), 4)])
def test_reference_masks_are_the_collators(grid, rows):
    from bvc_tpu_torch.masks.multiblock3d import MultiBlock3DMaskCollator

    mask = {"pred_mask_scale": [0.15, 0.15] if grid[1] == 16 else [0.3, 0.3],
            "aspect_ratio": [0.75, 1.5], "pred_num_blocks": 8 if grid[1] == 16 else 2}
    col = MultiBlock3DMaskCollator(grid=grid, scale=tuple(mask["pred_mask_scale"]),
                                   aspect_ratio=tuple(mask["aspect_ratio"]),
                                   num_blocks=mask["pred_num_blocks"], seed=2**31 + 1)
    for step in range(3):
        enc, pred = masks3d.multiblock3d(2**31 + 1, step, rows, grid, mask)
        want_enc, want_pred = col(rows, step)
        assert np.array_equal(enc, want_enc) and np.array_equal(pred, want_pred)


def test_reference_rope_is_the_programs_eager_chain():
    from bvc_tpu_torch.ops.rope import rope_positions, rope_rotate, rope_tables

    from portbench.reference.vjepa2 import rope

    gen = torch.Generator().manual_seed(0)
    for d in (64, 32):
        x = torch.randn(2, 30, 3, d, generator=gen)
        ids = torch.randint(0, 2048, (2, 30), generator=gen)
        cos, sin = rope_tables((8, 16, 16), d, torch.device("cpu"))
        torch.testing.assert_close(rope(x, ids, (8, 16, 16)),
                                   rope_rotate(x, cos, sin, rope_positions(ids)),
                                   rtol=0, atol=1e-6)


def _reader(name: str):
    from portbench.tests.conftest import REPO

    return manifest.load_module(manifest.metric_path(REPO, name), "m_" + name.replace(".", "_"))


def test_the_readers_on_a_traced_cpu_run(root):
    line = run_on_cpu(root, CELL, seed=9, trace=True)
    metrics = line["metrics"]
    assert metrics["vitg_train_mfu"]["value"] > 0
    # no device time on the CPU: the device readers find nothing to read
    assert "rope_device_ms.train" not in metrics and "rope_roofline.train" not in metrics


def _view(calls: dict, steps: int = 2):
    trace = types.SimpleNamespace(steps=steps, op_calls=lambda op: calls.get(op, []))
    return types.SimpleNamespace(window={"op_trace": trace})


def test_the_rope_readers_arithmetic():
    fwd = [([[16, 2048, 22, 64], [16, 2048, 22, 64], [2048, 30], [2048, 30], [16, 2048]],
            200.0)]
    bwd = [([[16, 2048, 12, 32], [16, 2048, 12, 32], [2048, 15], [2048, 15], [16, 2048]],
            50.0)]
    view = _view({"bvc_tpu_torch::rope3d": fwd, "bvc_tpu_torch::rope3d_bwd": bwd,
                  "bvc::rope": [([], 210.0), ([], 60.0)]})
    bound = (arith_rope.rope_bound_ms(16, 2048, 22, 64, 2048, 30)
             + arith_rope.rope_bound_ms(16, 2048, 12, 32, 2048, 15))
    np.testing.assert_allclose(_reader("rope_roofline.train").read(view),
                               100 * bound * 1e3 / 250.0)
    np.testing.assert_allclose(_reader("rope_device_ms.train").read(view), 270.0 / 1e3 / 2)
    np.testing.assert_allclose(arith_rope.rope_bound_ms(16, 2048, 22, 64, 2048, 30),
                               (4 * 16 * 2048 * 22 * 64 * 2 + 16 * 2048 * 4 + 2 * 2048 * 30 * 4)
                               / 3.35e12 * 1e3)
    # a program without the operator (the parent of this cell): nothing to read
    for name in ("rope_roofline.train", "rope_device_ms.train"):
        assert _reader(name).read(_view({})) is None
        assert _reader(name).read(types.SimpleNamespace(window={})) is None


def test_the_step_count():
    from portbench.tests.conftest import REPO

    m = json.loads((REPO / "portbench/configs/vjepa2_vit_g.json").read_text())["model"]
    per_clip = arith_rope.vjepa2_train_flops_per_clip(m, 500, 1500)
    assert 8.0e12 < per_clip < 9.5e12
    target = arith_rope.blocks_flops(40, 2048, 1408, 6144)
    assert target == 40 * (8 * 2048 * 1408 ** 2 + 4 * 2048 * 1408 * 6144 + 4 * 2048 ** 2 * 1408)
    # with F = 4D and the predictor at the encoder's ratio, one layer's count
    # is the frozen VideoMAE count's 24 N D^2 + 4 N^2 D
    assert arith_rope.blocks_flops(1, 160, 768, 3072) == 24 * 160 * 768 ** 2 + 4 * 160 ** 2 * 768
    assert arith.PEAK_BF16_FLOPS == 989e12


def test_the_mfu_reader_finds_nothing_in_other_cells():
    view = types.SimpleNamespace(config={"mask": {"enc_mask_scale": [0.85, 1.0]}},
                                 model={}, window={"metrics_out": [{"loss": 1.0}]})
    assert _reader("vitg_train_mfu").read(view) is None
