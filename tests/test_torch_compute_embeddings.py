"""The port's benchmark readers (``bvc_tpu_torch.evalbench.datasets``) and
``compute_embeddings`` CLI against ``bvc_tpu``'s.

Readers: the same synthetic SSv2 frame folders (native and Python decode),
Toybox and UCF101 videos and CIFAR-10 pickles give bit-identical clips and
names (``np.testing.assert_array_equal``).  The CLI: a port checkpoint
written from JAX weights, run through ``main(argv, device="cpu")`` over a
synthetic CIFAR-10, writes the CSVs that JAX's ``extract_embeddings`` +
``save_results`` write from the same weights: the same rows and columns,
values within 1e-4 plus 1e-6 (f32 on both sides, written with 6 decimals).
"""

import json
import pickle
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from bvc_tpu import native as jax_native
from bvc_tpu.evalbench import datasets as jax_datasets
from bvc_tpu.evalbench import extract as jax_extract
from bvc_tpu.models import jepa as jax_jepa
from bvc_tpu.models import resnet as jax_resnet
from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.models.torch_interop import (jepa_encoder_to_reference, resnet_to_torch_state_dict,
                                          videomae_to_hf_state_dict)
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu_torch import native
from bvc_tpu_torch.cli import compute_embeddings
from bvc_tpu_torch.evalbench import datasets
from bvc_tpu_torch.evalbench.extract import make_task_dataset
from torch_port_config import without_port_only
from torch_jax_native import steady_jax_native

S = 16  # reader image size
SMALL_VIDEOMAE = dict(image_size=32, patch_size=8, num_frames=2, tubelet_size=2,
                      hidden_size=24, depth=2, num_heads=2, mlp_ratio=2.0,
                      decoder_hidden_size=16, decoder_depth=1, decoder_num_heads=2,
                      layer_norm_eps=1e-12, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_samples(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for i in range(len(theirs)):
        (clip, name), (want, want_name) = ours[i], theirs[i]
        assert name == want_name
        np.testing.assert_array_equal(clip, want, err_msg=f"sample {i}")


def _write_frames(d: Path, n: int, rng, shape=(24, 32, 3)):
    from PIL import Image

    d.mkdir(parents=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, shape, dtype=np.uint8)).save(d / f"{i}.jpg")


def _write_video(path: Path, n: int, rng, fps: int = 25):
    import cv2

    path.parent.mkdir(parents=True, exist_ok=True)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps, (32, 24))
    assert w.isOpened()
    for _ in range(n):
        w.write(rng.integers(0, 255, (24, 32, 3), dtype=np.uint8))
    w.release()


def write_cifar(root: Path, n_test: int = 10, n_train: int = 20) -> str:
    """CIFAR-10 in its ``cifar-10-batches-py`` pickle format: uint8 rows
    ``[N, 3072]`` (channel-major) and ``labels``."""
    base = root / "cifar-10-batches-py"
    base.mkdir(parents=True)
    rng = np.random.default_rng(0)
    names = ["test_batch"] + [f"data_batch_{i}" for i in range(1, 6)]
    for name in names:
        n = n_test if name == "test_batch" else n_train // 5
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         b"labels": [int(x) for x in rng.permutation(10)[:n] % 10]}, f)
    return str(root)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("train,sample_len", [(True, 8), (False, 20)], ids=["train", "val-padded"])
def test_ssv2_reader_matches_jax(tmp_path, use_native, train, sample_len):
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        for vid in range(3):
            _write_frames(tmp_path / split / str(vid), 12, rng)
    if use_native:  # the JAX package's load may have hit another worker's build
        assert native.available() == (steady_jax_native() if native.available()
                                      else jax_native.available())
    kw = dict(frame_rate=12, sample_len=sample_len, train=train, image_size=S,
              use_native=use_native)
    _same_samples(datasets.SSv2Dataset(str(tmp_path), **kw),
                  jax_datasets.SSv2Dataset(str(tmp_path), **kw))


def test_toybox_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    for obj, n in (("cat_01", 30), ("cup_02", 5)):
        for view in ("present", "rxminus"):
            _write_video(tmp_path / "animals" / obj / f"{obj}_{view}.avi", n, rng, fps=10)
    _same_samples(datasets.ToyboxDataset(str(tmp_path), 10, 8, S),
                  jax_datasets.ToyboxDataset(str(tmp_path), 10, 8, S))


@pytest.mark.parametrize("frame_rate,step", [(None, 16), (5, 300)])
def test_ucf101_reader_matches_jax(tmp_path, frame_rate, step):
    rng = np.random.default_rng(2)
    root = tmp_path / "UCF-101"
    entries = []
    for label, n in (("Basketball", 40), ("Diving", 40), ("Punch", 4)):
        rel = f"{label}/v_{label}_g01_c01.avi"
        _write_video(root / rel, n, rng)
        entries.append(rel)
    readers = []
    for mod, sub in ((datasets, "port"), (jax_datasets, "jax")):
        ann = tmp_path / sub  # each package probes into its own cache
        ann.mkdir()
        (ann / "trainlist01.txt").write_text("\n".join(f"{e} 1" for e in entries) + "\n")
        (ann / "testlist01.txt").write_text("\n".join(entries) + "\n")
        with pytest.warns(UserWarning, match="contribute no clips"):
            readers.append(mod.UCF101Dataset(str(root), str(ann), fold=1, train=True,
                                             sample_len=8, frame_rate=frame_rate,
                                             step_between_clips=step, image_size=S))
    ours, theirs = readers
    assert ours.clips == theirs.clips
    _same_samples(ours, theirs)
    for n, fps, fr in ((40, 25, 5), (41, 30, 12), (7, 12, 12)):
        assert datasets.resampled_length(n, fps, fr) == jax_datasets.resampled_length(n, fps, fr)
        np.testing.assert_array_equal(datasets.resample_video_idx(np.arange(6), fps, fr),
                                      jax_datasets.resample_video_idx(np.arange(6), fps, fr))


@pytest.mark.parametrize("train", [True, False])
def test_cifar10_reader_matches_jax(tmp_path, train):
    root = write_cifar(tmp_path)
    ours = make_task_dataset("cifar10", root, 12, 4, train=train, image_size=S)
    theirs = jax_extract.make_task_dataset("cifar10", root, 12, 4, train=train, image_size=S)
    assert len(ours) == (20 if train else 10)
    _same_samples(ours, theirs)
    with pytest.raises(ValueError, match="kinetics"):
        make_task_dataset("kinetics", root, 12, 4, train=train)


def _family_setup(family, tmp_path):
    """(argv flags, port checkpoint path, JAX embed fn) for one family's
    weights, written into a ``model_{run_id}.pth.tar`` of the port's
    layout."""
    ckpt = tmp_path / "ckpts" / "model_dev_1_g0_default_0_0.pth.tar"
    ckpt.parent.mkdir()
    key = jax.random.PRNGKey(7)
    if family == "videomae":
        jcfg = JaxModelConfig(**SMALL_VIDEOMAE)
        tree = jax.tree_util.tree_map(np.asarray, jax_videomae.init_params(key, jcfg))
        entry = {"model_state_dict": videomae_to_hf_state_dict(tree, jcfg)}
        fn = jax.jit(lambda v: jax_videomae.embed(tree, v, jcfg))
        flags = ["--num_frames", "2", "--image_size", "32"]
    elif family == "jepa":
        jcfg = JaxModelConfig(family="jepa", image_size=32, num_frames=2, tubelet_size=1,
                              hidden_size=192, depth=12, num_heads=3, dtype="float32")
        tree = jax.tree_util.tree_map(np.asarray, jax_jepa.init_encoder_params(key, jcfg))
        entry = {"encoder": jepa_encoder_to_reference(tree, jcfg)}
        fn = jax.jit(lambda v: jax_jepa.embed(tree, v, jcfg))
        flags = ["--num_frames", "2", "--tubelet_size", "1", "--image_size", "32",
                 "--architecture", "tiny"]
    else:
        params, stats = jax.tree_util.tree_map(
            np.asarray, jax_resnet.init_params(key, "resnet18", head_dim=16))
        entry = {"model_state_dict": resnet_to_torch_state_dict(params, stats, "resnet18")}
        fn = jax.jit(lambda v: jax_resnet.apply(params, stats, v[:, -1], "resnet18",
                                                training=False, with_head=False)[0])
        flags = ["--num_frames", "2", "--image_size", "32", "--architecture", "resnet18"]
    torch.save({k: {n: torch.from_numpy(np.array(x)) for n, x in v.items()}
                for k, v in entry.items()}, ckpt)
    return flags, ckpt, lambda v: np.asarray(fn(jnp.asarray(v)))


@pytest.mark.parametrize("family", ["videomae", "jepa", "simclr"])
def test_csvs_match_jax(family, tmp_path, monkeypatch, capsys):
    flags, ckpt, jax_fn = _family_setup(family, tmp_path)
    parse = compute_embeddings.model_config_from_args

    def small_f32(args):
        """The CLI builds ViT-B in bf16: its widths shrunk and its dtype set
        to f32 inside the test, as the JAX embed above runs."""
        cfg = parse(args)
        for k, v in (SMALL_VIDEOMAE.items() if family == "videomae" else ()):
            setattr(cfg, k, v)
        cfg.dtype = "float32"
        return cfg

    monkeypatch.setattr(compute_embeddings, "model_config_from_args", small_f32)
    root = write_cifar(tmp_path / "cifar")
    argv = ["-ds_task", "cifar10", "-vid_root", root, "-savedir", str(tmp_path / "port"),
            "--family", family, "--batch_size", "4", "--num_workers", "2", *flags]
    results = compute_embeddings.main(argv + ["-init_checkpoint_path", str(ckpt)],
                                      device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == results
    assert [(r["phase"], r["rows"]) for r in results] == [("train", 20), ("test", 10)]
    width = {"videomae": 24, "jepa": 192, "simclr": 512}[family]
    for r in results:
        ds = jax_extract.make_task_dataset("cifar10", root, 12, 2, train=r["phase"] == "train",
                                           image_size=32)
        names, embs = jax_extract.extract_embeddings(jax_fn, ds, batch_size=4, num_workers=2)
        want = pd.read_csv(jax_extract.save_results(names, embs, r["phase"],
                                                    "dev_1_g0_default_0_0",
                                                    str(tmp_path / "jax")))
        got = pd.read_csv(r["csv"])
        assert r["csv"].endswith(("test/" if r["phase"] == "test" else "")
                                 + "embeddings_dev_1_g0_default_0_0.csv")
        assert list(got.columns) == list(want.columns) == ["fnames"] + [
            f"dim{i}" for i in range(width)]
        assert list(got["fnames"]) == list(want["fnames"])
        np.testing.assert_allclose(got.iloc[:, 1:].to_numpy(), want.iloc[:, 1:].to_numpy(),
                                   rtol=0, atol=1e-4 + 1e-6)


def test_sweep_resume_untrained_and_mesh(tmp_path, capsys):
    """``--checkpoint_dir`` embeds with every ``model_*.pth.tar`` in it (not
    other files), ``--resume y`` skips the (checkpoint, split) pairs whose
    CSV exists, ``-init_checkpoint_path na`` embeds the untrained model, and
    ``--mesh data=2`` in one process raises (it needs two ranks), and a
    ``seq`` mesh refuses SimCLR with the JAX package's reason (it embeds
    one frame)."""
    flags, ckpt, _ = _family_setup("simclr", tmp_path)
    shutil.copy(ckpt, ckpt.with_name("model_dev_2_g1_default_0_0.pth.tar"))
    (ckpt.parent / "model_dev_3_g2_default_0_0.ckpt").mkdir()  # a JAX Orbax dir: not read
    root = write_cifar(tmp_path / "cifar")
    base = ["-ds_task", "cifar10", "-vid_root", root, "-savedir", str(tmp_path / "out"),
            "--family", "simclr", "--batch_size", "8", "--num_workers", "2",
            "--dataset_split", "test", *flags]
    sweep = base + ["--checkpoint_dir", str(ckpt.parent)]
    results = compute_embeddings.main(sweep, device="cpu")
    assert [Path(r["csv"]).name for r in results] == [
        "embeddings_dev_1_g0_default_0_0.csv", "embeddings_dev_2_g1_default_0_0.csv"]
    first = pd.read_csv(results[0]["csv"])
    pd.testing.assert_frame_equal(first, pd.read_csv(results[1]["csv"]))
    assert compute_embeddings.main(sweep + ["--resume", "y"], device="cpu") == []
    untrained = compute_embeddings.main(base + ["--seed", "3"], device="cpu")
    assert Path(untrained[0]["csv"]).name == "embeddings_untrained_0_na_na_0_3.csv"
    assert pd.read_csv(untrained[0]["csv"]).shape == (10, 513)
    capsys.readouterr()
    with pytest.raises(ValueError, match="needs 2 processes, this run has 1"):
        compute_embeddings.main(base + ["--mesh", "data=2"], device="cpu")
    with pytest.raises(ValueError, match="sequence-parallel extraction supports videomae "
                                         "and jepa"):
        compute_embeddings.main(base + ["--mesh", "data=1,seq=1"], device="cpu")
    with pytest.raises(ValueError, match="resnet conv trunk"):
        compute_embeddings.main(base + ["--quantize", "int8"], device="cpu")


def test_flags_match_jax():
    from bvc_tpu.cli import compute_embeddings as jax_cli

    ours = {a.dest: a.default for a in compute_embeddings.build_parser()._actions}
    theirs = {a.dest: a.default for a in jax_cli.build_parser()._actions}
    assert ours == theirs
    for family, arch in (("videomae", "base"), ("jepa", "small"), ("simclr", "base"),
                         ("simclr", "resnet50")):
        argv = ["-ds_task", "ssv2", "-vid_root", "x", "-savedir", "y", "--family", family,
                "--architecture", arch]
        got = compute_embeddings.model_config_from_args(
            compute_embeddings.build_parser().parse_args(argv))
        want = jax_cli.model_config_from_args(jax_cli.build_parser().parse_args(argv))
        assert without_port_only({k: getattr(got, k) for k in got.__dataclass_fields__},
                                 "model") == {k: getattr(want, k)
                                              for k in want.__dataclass_fields__}
