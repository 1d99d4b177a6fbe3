"""The three pretraining CLIs under the parameter layouts at world 2
(gloo ranks on the CPU, ``tests/test_torch_sharding_ranks.py``), 2 steps at
a global batch of 8: ``--param_sharding fsdp`` (``data=2``, 4 clips a
rank) and ``--mesh data=1,model=2 --param_sharding tp`` (each rank on the
whole batch of 4 x 2, the JAX CLIs' per-device flag).  Each writes rank
0's CSV and one checkpoint whose meta counts both ranks, and its mean loss
equals its reference's within rtol 1e-5; its CSV rows (losses and gradient
metrics) too, within rtol 1e-5 and atol 1e-5, one unit of the CSV's last
printed decimal of the loss (``%.5f``).  The reference of ``tp`` is the CLI
in one process at ``--batch_size 8``; that of ``fsdp`` the CLI at the same
``data=2`` under ``replicated`` (DDP): at 32 px SimCLR's deepest BatchNorms
see 16 values, and splitting their sums over two ranks moves its conv1
gradient norm by 3e-4 of itself under DDP as under FSDP.  The models run
in f32 (the CLIs' default is bf16, whose roundings the ranks' other
summation orders flip); SimCLR at lr 1e-4, as every SimCLR parity test of
the port: InfoNCE's gradient norm is near 190 at init, and a larger step
lets f32 rounding decide the trajectory.  The JEPA CLI's ``tiny`` ViT has 3 heads: at
``model=2`` its blocks stay whole.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bvc_tpu_torch.cli import pretrain_jepa, pretrain_simclr, pretrain_videomae
from bvc_tpu_torch.training.checkpoint import load_meta
from test_torch_sharding_ranks import with_model_fields
from torch_ranks import run_ranks
from torch_tiny_runs import VIDEOMAE_MODEL

RTOL, CSV_ATOL = 1e-5, 1e-5
RUN_ID = "dev_1_g0_default_0_0"
CLIS = {"videomae": pretrain_videomae, "jepa": pretrain_jepa, "simclr": pretrain_simclr}
# the parsed model's fields: f32, and the VideoMAE CLI's ViT-B cut to size
MODEL_FIELDS = {"videomae": {k: v for k, v in VIDEOMAE_MODEL.items()
                             if k not in ("image_size", "num_frames", "tubelet_size")},
                "jepa": {"dtype": "float32"}, "simclr": {"dtype": "float32"}}
LAYOUTS = {"fsdp": ["--param_sharding", "fsdp"],
           "tp": ["--mesh", "data=1,model=2", "--param_sharding", "tp"]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(family: str, corpus: str, savedir, batch: int, *extra) -> list[str]:
    """``tests/test_torch_cli.py``'s tiny runs (2 steps of 8 clips)."""
    common = ["-jpg_root", corpus, "-savedir", str(savedir), "--batch_size", str(batch),
              "--n_trainsamples", "16", "--max_epoch_iters", "2", "--segment_minutes", "0.02",
              "--num_workers", "2", "--run_id", RUN_ID]
    if family == "videomae":
        return common + ["--image_size", "32", "--num_frames", "4", *extra]
    if family == "simclr":
        return common + ["--image_size", "32", "--pred_emb_dim", "16", "--interval", "5",
                         "--augs", "n", "--lr", "1e-4", *extra]
    return common + ["--image_size", "64", "--architecture", "tiny", "--pred_emb_dim", "24",
                     "--pred_depth", "1", "--interval", "5", *extra]


def _rows(folder) -> np.ndarray:
    lines = (folder / f"csvlog_{RUN_ID}.csv").read_text().splitlines()
    assert len(lines) == 1 + 2
    return np.array([[float(x) for x in line.split(",")] for line in lines[1:]])


_REFS: dict = {}


def _reference(family, layout, corpus, tmp_path_factory, monkeypatch) -> tuple:
    """The reference run's summary and CSV rows, once a family and layout:
    for ``tp`` the CLI in this process at ``--batch_size 8``, for ``fsdp``
    the CLI at world 2 under ``replicated``."""
    if (family, layout) not in _REFS:
        out = tmp_path_factory.mktemp(f"ref_{family}_{layout}")
        if layout == "fsdp":
            summary = run_ranks("cli", {"family": family, "model": MODEL_FIELDS[family],
                                        "argv": _argv(family, corpus, out / "run", 4)},
                                out / "ranks", module="test_torch_sharding_ranks")[0]
            out = out / "run"
        else:
            monkeypatch.setattr(CLIS[family], "config_from_args",
                                CLIS[family].config_from_args)
            with_model_fields(CLIS[family], MODEL_FIELDS[family])
            summary = CLIS[family].main(_argv(family, corpus, out, 8), device="cpu")
        _REFS[family, layout] = summary, _rows(out)
    return _REFS[family, layout]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("family", list(CLIS))
def test_cli_at_world2(family, layout, frame_corpus, tmp_path, tmp_path_factory, monkeypatch):
    out = tmp_path / "out"
    summaries = run_ranks("cli", {"family": family, "model": MODEL_FIELDS[family],
                                  "argv": _argv(family, frame_corpus, out, 4,
                                                *LAYOUTS[layout])}, tmp_path / "ranks",
                          module="test_torch_sharding_ranks")
    assert summaries[0] == summaries[1]
    assert load_meta(summaries[0]["checkpoint"])["world_size"] == 2
    summary, want = _reference(family, layout, frame_corpus, tmp_path_factory, monkeypatch)
    np.testing.assert_allclose(summaries[0]["train_loss"], summary["train_loss"], rtol=RTOL)
    cols = slice(0, -1) if family != "videomae" else slice(None)  # the time (ms) column
    np.testing.assert_allclose(_rows(out)[:, cols], want[:, cols], rtol=RTOL, atol=CSV_ATOL)
