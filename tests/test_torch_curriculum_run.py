"""Real tiny curricula on the CPU through the port's ``run_curriculum``: two
chained stages per family over a corpus of two ``g0`` subjects and one
``g1`` subject (120 frames of 32x32 each), the extraction sweep over an
SSv2-layout benchmark, and ``evaluate_embeddings`` over its CSVs.

VideoMAE runs in both packages from the same initial weights and masks (the
JAX trainer's, handed to the port by patching its model constructor and
tube sampler inside the test, as ``tests/test_torch_trainer.py`` does), at
the global batch 8 (the port at 8 on one device, JAX at 1 x 8 CPU devices):
each stage's CSV losses and gradient norms within that test's rtol 5e-4 /
atol 1e-5 (read: equal to the CSV's 5 digits), and the sweep's embeddings
within 1e-3 x max|JAX's| (read: 6.5e-7 of it).  JEPA and SimCLR run in the
port alone: chaining, the stage-0 baseline, the CSVs and the scores.  The
configs are ``tests/torch_tiny_runs.py``'s, and the presets are cut to them:
3 steps of 8 clips, mask ratio 0.75, a JEPA ViT 32 wide and 2 deep (as
``vit_micro``), SimCLR at lr 1e-4 then 1e-3 with pairs 5 then 3 frames
apart, no augmentation.
"""

import dataclasses
import json

import jax
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from bvc_tpu.cli import evaluate_embeddings as jax_evaluate
from bvc_tpu.curriculum import presets as jax_presets
from bvc_tpu.curriculum.driver import run_curriculum as jax_run_curriculum
from bvc_tpu.masks.tube import tube_mask as jax_tube_mask
from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.utils.config import TrainConfig as JaxTrainConfig
from bvc_tpu_torch.cli import evaluate_embeddings
from bvc_tpu_torch.curriculum import FAMILY_PRESETS, run_curriculum
from bvc_tpu_torch.models.convert import videomae_pretrain_from_jax_params
from bvc_tpu_torch.models.videomae import VideoMAEPretrain
from bvc_tpu_torch.training import steps, trainer_videomae
from bvc_tpu_torch.training.checkpoint import load_meta
from bvc_tpu_torch.utils import config as port_config
from bvc_tpu_torch.utils.config import TrainConfig
from torch_tiny_runs import tiny_cfg

RTOL, ATOL = 5e-4, 1e-5
EMBED_TOL = 1e-3  # of max|JAX's embedding|
MANIFEST_KEYS = {"curriculum", "stages", "final_checkpoint", "extraction"}
STAGE_KEYS = {"stage", "train_group", "fold", "run_id", "overrides", "checkpoint", "train_loss"}
RUN_IDS = ["dev_1_g0_default_1_0", "dev_2_g1_default_2_0"]
TINY_PRESETS = {
    "videomae": ("generative", dict(mask_ratio=0.75, num_frames=4)),
    "jepa": ("predictive", dict(lr=0.03, num_frames=2, interval=5, pred_mask_scale=0.2,
                                architecture="micro", augs="n")),
    "simclr": ("contrastive", dict(lr=1e-4, num_frames=2, interval=5, pred_emb_dim=16,
                                   augs="n", stage_overrides={1: {"lr": 1e-3, "interval": 3}})),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """``frame_corpus``'s layout with 120 frames a subject: each fold of the
    ``g1`` subject holds 36 or more (segments of 36 frames)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("curriculum_corpus")
    rng = np.random.default_rng(1)
    for subject in ["008MS", "009SS", "026AR"]:
        (root / subject).mkdir()
        for i in range(120):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
                root / subject / f"frame_{i:05d}.jpg", quality=90)
    return str(root)


@pytest.fixture(scope="module")
def ssv2(tmp_path_factory):
    """An SSv2 layout (``{train,val}/<id>/<n>.jpg``), 4 clips a split of 6
    frames, two classes of two clips, and the label CSVs keyed by
    ``<id>.webm``."""
    from PIL import Image

    root = tmp_path_factory.mktemp("ssv2")
    rng = np.random.default_rng(0)
    for split, first in (("train", 0), ("val", 100)):
        rows = []
        for i in range(4):
            (root / split / str(first + i)).mkdir(parents=True)
            for f in range(6):
                Image.fromarray(rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)).save(
                    root / split / str(first + i) / f"{f}.jpg")
            rows.append({"fname": f"{first + i}.webm", "label": "ab"[i % 2]})
        pd.DataFrame(rows).to_csv(root / f"{split}_labels.csv", index=False)
    return root


def _preset(presets, family, batch_size):
    name, kw = TINY_PRESETS[family]
    return dataclasses.replace(presets[name], n_epoch=1, max_epoch_iters=3, n_trainsamples=24,
                               batch_size=batch_size, tubelet_size=1 if family != "videomae"
                               else 2, **kw)


def _base(Cfg, family, corpus, savedir, **top):
    return tiny_cfg(Cfg, family, corpus, savedir, "unused", **top)


def _task(ssv2):
    return [{"ds_task": "ssv2", "vid_root": str(ssv2), "frame_rate": 12, "batch_size": 4}]


def _score(module, savedir, ssv2, eval_type):
    np.random.seed(0)  # the probe's shuffle seeds come from numpy's global generator
    return module.main(["-emb_root", str(savedir / "benchmarks" / "ssv2"), "-ds_task", "ssv2",
                        "--ssv2_train_labels", str(ssv2 / "train_labels.csv"),
                        "--ssv2_test_labels", str(ssv2 / "val_labels.csv"),
                        "--eval_type", eval_type, "--n_jobs", "1"])


def _csv(path):
    lines = path.read_text().splitlines()
    return lines[0], np.array([[float(x) for x in row.split(",")] for row in lines[1:]])


def _check_chain(results, savedir, run_ids):
    """Manifest keys, run ids and folds, each stage started from the one
    before it, a train and a test CSV per run id."""
    manifest = json.loads((savedir / "curriculum_dev_default_0.json").read_text())
    assert set(manifest) == MANIFEST_KEYS and manifest == json.loads(json.dumps(results,
                                                                                  default=str))
    stages = manifest["stages"]
    assert [s["run_id"] for s in stages] == RUN_IDS
    assert [s["fold"] for s in stages] == [1, 2]
    assert all(STAGE_KEYS <= set(s) for s in stages)
    assert [s["checkpoint"] for s in stages] == [str(savedir / f"model_{r}.pth.tar")
                                                 for r in RUN_IDS]
    params = yaml.safe_load((savedir / f"params_{RUN_IDS[1]}.yaml").read_text())
    assert params["init_checkpoint_path"] == stages[0]["checkpoint"]
    assert manifest["final_checkpoint"] == stages[1]["checkpoint"]
    emb = savedir / "benchmarks" / "ssv2"
    for rid in run_ids:
        for sub in ("", "test"):
            df = pd.read_csv(emb / sub / f"embeddings_{rid}.csv")
            assert len(df) == 4 and np.isfinite(df.filter(like="dim").to_numpy()).all()
    assert sorted((e["run_id"], e["phase"]) for e in manifest["extraction"]) == sorted(
        (r, p) for r in run_ids for p in ("train", "test"))
    return manifest


@pytest.fixture(scope="module")
def videomae_runs(corpus, ssv2, tmp_path_factory):
    """The JAX curriculum, then the port's from JAX's initial weights and
    masks: each stage's step i draws JAX's mask i (both trainers start each
    stage's mask stream at ``seed + 1``)."""
    root = tmp_path_factory.mktemp("videomae_runs")
    jbase = _base(JaxTrainConfig, "videomae", corpus, root / "jax", batch_size=1)
    jax_results = jax_run_curriculum("dev", _preset(jax_presets.FAMILY_PRESETS, "videomae", 1),
                                     jbase, n_stages=2, extraction=_task(ssv2))
    m = jbase.model
    tree = jax.tree_util.tree_map(np.asarray, jax_videomae.init_params(
        jax.random.PRNGKey(jbase.seed), m))
    grid = (4 // 2, m.image_size // m.patch_size, m.image_size // m.patch_size)
    key, masks = jax.random.PRNGKey(jbase.seed + 1), []
    for _ in range(3):
        key, mask_rng = jax.random.split(key)
        masks.append(torch.from_numpy(np.array(jax_tube_mask(mask_rng, 8, grid, 0.75))))
    masks = masks * 2

    def build(cfg, *args, **kw):
        model = VideoMAEPretrain(cfg, *args, **kw)
        model.load_state_dict(videomae_pretrain_from_jax_params(tree, cfg))
        return model

    base = _base(TrainConfig, "videomae", corpus, root / "port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_videomae, "VideoMAEPretrain", build)
        mp.setattr(steps, "tube_mask", lambda gen, batch, grid, mask_ratio: masks.pop(0))
        results = run_curriculum("dev", _preset(FAMILY_PRESETS, "videomae", 8), base,
                                 n_stages=2, extraction=_task(ssv2), device="cpu")
    assert masks == []
    return root, jax_results, results


def test_videomae_curriculum_matches_jax(videomae_runs, ssv2):
    root, jax_results, results = videomae_runs
    port, jax_dir = root / "port", root / "jax"
    _check_chain(results, port, RUN_IDS)
    assert [s["run_id"] for s in jax_results["stages"]] == RUN_IDS
    for rid in RUN_IDS:
        header, rows = _csv(port / f"csvlog_{rid}.csv")
        jheader, jrows = _csv(jax_dir / f"csvlog_{rid}.csv")
        assert header == jheader and rows.shape == jrows.shape == (3, 7)
        np.testing.assert_array_equal(rows[:, :2], jrows[:, :2])
        np.testing.assert_allclose(rows[:, 2], jrows[:, 2], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(rows[:, 4:], jrows[:, 4:], rtol=RTOL)
        for sub in ("", "test"):
            ours = pd.read_csv(port / "benchmarks" / "ssv2" / sub / f"embeddings_{rid}.csv")
            theirs = pd.read_csv(jax_dir / "benchmarks" / "ssv2" / sub / f"embeddings_{rid}.csv")
            assert list(ours["fnames"]) == list(theirs["fnames"])
            ref = theirs.filter(like="dim").to_numpy()
            np.testing.assert_allclose(ours.filter(like="dim").to_numpy(), ref, rtol=0,
                                       atol=EMBED_TOL * np.abs(ref).max())


@pytest.mark.parametrize("eval_type", ["linear", "nn"])
def test_videomae_curriculum_scores(videomae_runs, ssv2, eval_type):
    """``evaluate_embeddings`` over the port's sweep: one row a run id, finite
    scores, and the same table as the JAX package's CLI on the same CSVs."""
    port = videomae_runs[0] / "port"
    df = _score(evaluate_embeddings, port, ssv2, eval_type)
    assert list(df["Stage"]) == [1, 2] and list(df["Train Groups"]) == ["g0", "g0g1"]
    cols = ["category"] if eval_type == "linear" else ["Top1", "Top5", "Top10"]
    assert np.isfinite(df[cols].to_numpy(dtype=float)).all()
    pd.testing.assert_frame_equal(df, _score(jax_evaluate, port, ssv2, eval_type))


@pytest.mark.parametrize("family", ["jepa", "simclr"])
def test_curriculum_runs(family, corpus, ssv2, tmp_path, monkeypatch):
    """Two chained stages, the stage-0 baseline and the sweep, then both
    scores; the JEPA stage 2 counts its epochs on from stage 1's."""
    monkeypatch.setitem(port_config.VIT_DIMS, "vit_micro", (32, 2, 2))
    results = run_curriculum("dev", _preset(FAMILY_PRESETS, family, 8),
                             _base(TrainConfig, family, corpus, tmp_path), n_stages=2,
                             extraction=_task(ssv2), untrained_baseline=True, device="cpu")
    baseline = "dev_0_na_default_0_0"
    manifest = _check_chain(results, tmp_path, [baseline] + RUN_IDS)
    assert manifest["extraction"][0]["run_id"] == baseline
    assert load_meta(manifest["final_checkpoint"])["epoch"] == (2 if family == "jepa" else 1)
    for eval_type in ("linear", "nn"):
        df = _score(evaluate_embeddings, tmp_path, ssv2, eval_type)
        assert list(df["Stage"]) == [0, 1, 2]


def test_curriculum_level_resume_skips_completed_stages(corpus, tmp_path):
    """A killed curriculum re-run with ``resume`` skips its finished stages
    (their checkpoints untouched) and trains the rest from them."""
    def base():
        b = _base(TrainConfig, "videomae", corpus, tmp_path)
        b.resume = b.save_every_epoch = True
        return b

    preset = _preset(FAMILY_PRESETS, "videomae", 8)
    run_curriculum("dev", preset, base(), n_stages=1, device="cpu")
    ck1 = tmp_path / f"model_{RUN_IDS[0]}.pth.tar"
    mtime = ck1.stat().st_mtime_ns
    results = run_curriculum("dev", preset, base(), n_stages=2, device="cpu")
    assert len(results["stages"]) == 2
    assert ck1.stat().st_mtime_ns == mtime
    assert (tmp_path / f"model_{RUN_IDS[1]}.pth.tar").is_file()
    assert len((tmp_path / f"csvlog_{RUN_IDS[0]}.csv").read_text().splitlines()) == 1 + 3
