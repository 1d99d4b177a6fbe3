"""The port stands alone: no JAX and nothing of ``bvc_tpu`` is imported (nor
scikit-learn, which the card's host lacks: the evaluation scores with its
own numpy probes), entry points never fall back to the CPU on their own, and
``chip_smoke.py`` refuses to run without a card or outside a checkout."""

import ast
import copy
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bvc_tpu_torch
from bvc_tpu_torch.cli import (compute_embeddings, export_serving, pretrain_jepa,
                               pretrain_simclr, pretrain_videomae, run_curriculum)
from bvc_tpu_torch.data.loader import DataLoader
from bvc_tpu_torch.evalbench import extract
from bvc_tpu_torch.masks.multiblock import mask_collate
from bvc_tpu_torch.models.jepa import JEPA
from bvc_tpu_torch.models.videomae import VideoMAEPretrain
from bvc_tpu_torch.ops import _build
from bvc_tpu_torch.serving import export_embed, load_artifact
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_jepa_train_step, make_videomae_train_step
from bvc_tpu_torch.training.trainer_jepa import run_pretraining as run_jepa
from bvc_tpu_torch.training.trainer_simclr import run_pretraining as run_simclr
from bvc_tpu_torch.training.trainer_videomae import run_pretraining as run_videomae
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig, TrainConfig
from bvc_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
PACKAGE = Path(bvc_tpu_torch.__file__).parent
PY_FILES = sorted(PACKAGE.rglob("*.py"))
# the curriculum and evaluation slice: held to the same rules by name, so
# that a module moved out of the package cannot drop out of these tests
SLICE_8A = ["curriculum/__init__.py", "curriculum/presets.py", "curriculum/driver.py",
            "evalbench/scores.py", "evalbench/evaluators.py", "cli/run_curriculum.py",
            "cli/evaluate_embeddings.py", "cli/pack_corpus.py"]
# the export slice and the image ViT
SLICE_8B = ["serving/__init__.py", "serving/export.py", "cli/export_serving.py",
            "models/vit_image.py"]
# data-parallel training and extraction, and the modules that learnt about ranks
SLICE_7A = ["parallel/__init__.py", "parallel/mesh.py", "parallel/collectives.py",
            "parallel/sharding.py", "utils/device.py", "data/loader.py", "models/resnet.py",
            "objectives/contrastive.py", "training/steps.py", "training/state.py",
            "training/optim.py", "training/trainer_videomae.py", "training/trainer_jepa.py",
            "training/trainer_simclr.py", "training/async_checkpoint.py",
            "evalbench/extract.py", "cli/common.py", "cli/compute_embeddings.py",
            "cli/run_curriculum.py", "curriculum/driver.py"]


def test_slice_8a_modules_are_checked():
    assert {PACKAGE / name for name in SLICE_8A} <= set(PY_FILES)


def test_slice_8b_modules_are_checked():
    assert {PACKAGE / name for name in SLICE_8B} <= set(PY_FILES)


def test_slice_7a_modules_are_checked():
    assert {PACKAGE / name for name in SLICE_7A} <= set(PY_FILES)


def test_import_pulls_in_no_jax_and_no_bvc_tpu():
    code = (
        "import importlib, pkgutil, sys, bvc_tpu_torch\n"
        "for m in pkgutil.walk_packages(bvc_tpu_torch.__path__, 'bvc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'bvc_tpu', 'sklearn')]\n"
        "print(len([k for k in sys.modules if k.startswith('bvc_tpu_torch.')]), bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= len(PY_FILES) - 1  # every module but the package itself
    assert out[1].strip() == "[]"


@pytest.mark.parametrize("path", PY_FILES, ids=lambda p: str(p.relative_to(PACKAGE)))
def test_source_imports_neither_jax_nor_bvc_tpu(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "bvc_tpu", "flax", "optax", "sklearn"), (
                path, name)


def test_no_silent_cpu_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(image_size=32, patch_size=8, num_frames=4, hidden_size=16,
                      depth=1, num_heads=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract.untrained_embed_fn("videomae", cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract.make_embed_fn("videomae", "model_x.pth.tar", cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    model = VideoMAEPretrain(ModelConfig(**{**cfg.__dict__, "decoder_hidden_size": 16,
                                            "decoder_depth": 1, "decoder_num_heads": 1}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainState.create(model, OptimConfig())
    # the step runs where its state lives, and nowhere else
    state = TrainState.create(model, OptimConfig(), device="cpu")
    step = make_videomae_train_step(state.model.cfg, MaskConfig())
    video = torch.zeros((2, 4, 32, 32, 3), dtype=torch.uint8)
    assert all(m.device == torch.device("cpu") for m in step(state, video).values())


def test_no_silent_cpu_default_jepa(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(family="jepa", image_size=32, patch_size=8, num_frames=2,
                      tubelet_size=1, hidden_size=16, depth=1, num_heads=1, pred_depth=1,
                      pred_emb_dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract.untrained_embed_fn("jepa", cfg)
    model = JEPA(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainState.create(model, OptimConfig(), target=copy.deepcopy(model.encoder))
    state = TrainState.create(model, OptimConfig(), device="cpu",
                              target=copy.deepcopy(model.encoder))
    batch = {"video": torch.zeros((2, 2, 32, 32, 3), dtype=torch.uint8),
             **{k: torch.from_numpy(v) for k, v in
                mask_collate(cfg, MaskConfig(pred_mask_scale=(0.2, 0.25), min_keep=2))(
                    2, step=0).items()}}
    metrics = make_jepa_train_step(cfg, total_steps=10)(state, batch)
    assert all(m.device == torch.device("cpu") for m in metrics.values())
    assert state.target.patch_embed.weight.device == torch.device("cpu")


@pytest.mark.parametrize("entry", ["run_videomae", "run_jepa", "pretrain_videomae.main",
                                   "pretrain_jepa.main", "DataLoader", "run_simclr",
                                   "pretrain_simclr.main", "compute_embeddings.main",
                                   "run_curriculum.main", "export_serving.main",
                                   "export_embed", "load_artifact"])
def test_no_silent_cpu_default_training_loop(entry, monkeypatch, tmp_path):
    """The training loop's and extraction's entry points refuse to fall back
    to the CPU: with no GPU and no device named they raise before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrainConfig(savedir=str(tmp_path))
    argv = ["-savedir", str(tmp_path)]
    calls = {"run_videomae": lambda: run_videomae(cfg),
             "run_jepa": lambda: run_jepa(cfg),
             "run_simclr": lambda: run_simclr(cfg),
             "pretrain_videomae.main": lambda: pretrain_videomae.main(argv),
             "pretrain_jepa.main": lambda: pretrain_jepa.main(argv),
             "pretrain_simclr.main": lambda: pretrain_simclr.main(argv),
             "compute_embeddings.main": lambda: compute_embeddings.main(
                 ["-ds_task", "cifar10", "-vid_root", str(tmp_path), "-savedir",
                  str(tmp_path / "emb"), "--family", "simclr"]),
             "run_curriculum.main": lambda: run_curriculum.main(
                 ["-jpg_root", str(tmp_path), "-savedir", str(tmp_path / "out"),
                  "--extract", f"ssv2={tmp_path}", "--untrained_baseline", "y"]),
             "export_serving.main": lambda: export_serving.main(
                 ["-init_checkpoint_path", "na", "-out", str(tmp_path / "art")]),
             "export_embed": lambda: export_embed(
                 "videomae", torch.nn.Linear(1, 1), ModelConfig()),
             "load_artifact": lambda: load_artifact(tmp_path / "art"),
             "DataLoader": lambda: DataLoader(list(range(8)), 4, device=None)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    assert not any(tmp_path.iterdir())
    assert DataLoader(list(range(8)), 4, device="cpu").device == torch.device("cpu")
    assert DataLoader(list(range(8)), 4, to_device=False).device is None


def test_kernel_build_is_keyed_by_source_hash():
    path = _build.library_path("flash_fwd")
    assert path.parent == PACKAGE / "_build"
    assert path.name.startswith("libflash_fwd-") and path.suffix == ".so"
    assert path == _build.library_path("flash_fwd")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    ignored = (REPO / ".gitignore").read_text().split()
    assert "bvc_tpu_torch/_build/" in ignored


def test_nvcc_missing_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os, "access", lambda *_: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def _run_chip_smoke(cwd: Path, script: Path):
    return subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs for real there")
    proc = _run_chip_smoke(REPO, REPO / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_chip_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no bvc_tpu_torch package" in proc.stderr
