"""The port's input pipeline against ``bvc_tpu``'s: the copied index math,
transforms, native decode, packed corpus, datasets and factory (the
VideoMAE, JEPA and SimCLR families), and the loader's batches.

Tolerance: none.  The same corpus, config and seed give bit-identical
batches (``np.testing.assert_array_equal``) through the port's
``make_dataset`` + ``DataLoader(to_device=False)`` and the JAX package's
``make_dataset`` + ``DataLoader(mesh=None, to_device=False)``, over two
epochs, read by decode and through a packed corpus; the copies of the host
functions give equal outputs on equal inputs.
"""

import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from bvc_tpu import native as jax_native
from bvc_tpu.data import indexing as jax_indexing
from bvc_tpu.data import transforms as jax_transforms
from bvc_tpu.data.factory import make_dataset as jax_make_dataset
from bvc_tpu.data.loader import DataLoader as JaxDataLoader
from bvc_tpu.data.loader import EpochSampler as JaxEpochSampler
from bvc_tpu.data.packed import pack_corpus as jax_pack_corpus
from bvc_tpu.training.trainer_jepa import make_mask_collate as jax_make_mask_collate
from bvc_tpu.utils.config import DataConfig as JaxDataConfig
from bvc_tpu.utils.config import TrainConfig as JaxTrainConfig
from bvc_tpu_torch import native
from bvc_tpu_torch.data import indexing, transforms
from bvc_tpu_torch.data.factory import make_dataset
from bvc_tpu_torch.data.loader import DataLoader, EpochSampler
from bvc_tpu_torch.data.packed import PackedCorpus, pack_corpus, write_shard
from bvc_tpu_torch.training.trainer_jepa import make_mask_collate
from bvc_tpu_torch.utils.config import DataConfig, TrainConfig
from torch_jax_native import steady_jax_native


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S = 32


def _data_kw(frame_corpus, family, augs, pack_root=""):
    kw = dict(jpg_root=frame_corpus, train_group="g0", image_size=S, n_trainsamples=24,
              segment_minutes=0.02, batch_size=4, num_workers=3, seed=3, augs=augs,
              pack_root=pack_root)
    if family == "videomae":
        kw.update(num_frames=4, tubelet_size=2)
    else:
        kw.update(num_frames=2, tubelet_size=1, interval=5)
    return kw


@pytest.fixture(scope="module")
def pack_root(frame_corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_pack")
    assert pack_corpus(frame_corpus, str(out), image_size=S) == {
        "008MS": 60, "009SS": 60, "026AR": 60}
    return str(out)


def _jepa_collates(family, kw):
    """The two packages' mask collates of a JEPA run on this data (same
    collator code, so equal indices by construction)."""
    if family != "jepa":
        return None, None
    n_batches = kw["n_trainsamples"] // kw["batch_size"]
    cfgs = []
    for Cfg in (JaxTrainConfig, TrainConfig):
        cfg = Cfg(seed=kw["seed"])
        cfg.model.image_size, cfg.model.patch_size = S, 8
        cfg.model.num_frames, cfg.model.tubelet_size = 2, 1
        cfg.mask.pred_mask_scale, cfg.mask.min_keep = (0.2, 0.25), 2
        cfgs.append(cfg)
    return (jax_make_mask_collate(cfgs[0], n_batches)[0],
            make_mask_collate(cfgs[1], n_batches)[0])


@pytest.mark.parametrize("family,augs,packed", [
    ("videomae", "n", False), ("videomae", "cjbgo", False), ("videomae", "n", True),
    ("jepa", "n", False), ("jepa", "cjbgo", False), ("jepa", "n", True),
    ("simclr", "cjo", False), ("simclr", "n", False), ("simclr", "n", True)],
    ids=["videomae-n", "videomae-cjbgo", "videomae-packed", "jepa-n", "jepa-cjbgo",
         "jepa-packed", "simclr-cjo", "simclr-n", "simclr-packed"])
def test_loader_batches_match_jax(frame_corpus, pack_root, family, augs, packed):
    kw = _data_kw(frame_corpus, family, augs, pack_root if packed else "")
    ref_ds = jax_make_dataset(family, JaxDataConfig(**kw))["train"]
    ds = make_dataset(family, DataConfig(**kw))["train"]
    jax_collate, collate = _jepa_collates(family, kw)
    ref = JaxDataLoader(ref_ds, None, kw["batch_size"], seed=kw["seed"], num_workers=3,
                        to_device=False, collate_fn=jax_collate)
    loader = DataLoader(ds, kw["batch_size"], seed=kw["seed"], num_workers=3,
                        to_device=False, collate_fn=collate)
    assert len(loader) == len(ref) == 6
    for epoch in range(2):
        got, want = list(loader.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            if family == "jepa":
                assert set(g) == set(w) == {"video", "enc_idx", "pred_idx"}
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g.dtype == w.dtype == np.uint8
                np.testing.assert_array_equal(g, w)
    # which path read the frames: the packed rows when packed, else the
    # native decode for clips of the plain stack (the VideoMAE factory's
    # transform takes no augmentation) and the Python one for the frames of
    # JEPA's and SimCLR's pairs
    want_path = "packed" if packed else "native" if family == "videomae" else "python"
    assert set(ds.served) == {want_path}


def test_native_decode_matches_jax(frame_corpus):
    # the port builds its own library atomically; the JAX package's load may
    # have hit another worker's build of its library (steady_jax_native)
    jax_available = steady_jax_native() if native.available() else jax_native.available()
    assert native.available() == jax_available
    if not native.available():
        pytest.skip("no C++ compiler or libjpeg: both packages decode in Python")
    paths = [str(p) for p in sorted((Path(frame_corpus) / "008MS").iterdir())[:6]]
    for uint8 in (True, False):
        np.testing.assert_array_equal(native.decode_frames(paths, 24, uint8=uint8),
                                      jax_native.decode_frames(paths, 24, uint8=uint8))
    assert native.decode_frames(paths, 24, uint8=True).shape == (6, 24, 24, 3)
    with pytest.raises(IOError, match="missing.jpg"):
        native.decode_frames([paths[0], str(Path(frame_corpus) / "missing.jpg")], 24)


def test_packed_shards_match_jax(frame_corpus, pack_root, tmp_path):
    jax_pack_corpus(frame_corpus, str(tmp_path), image_size=S)
    for subj in ("008MS", "009SS", "026AR"):
        for suffix in ("u8", "json"):
            name = f"{subj}/frames_{S}.{suffix}"
            assert (Path(pack_root) / name).read_bytes() == (tmp_path / name).read_bytes()


def test_packed_clip_reads_match_jax(frame_corpus, pack_root):
    """The port reads a clip's frames in one gather a subject; the result is
    the JAX package's per-frame read, for consecutive, reordered and
    cross-subject clips, and None when a frame is missing."""
    from bvc_tpu.data.packed import PackedCorpus as JaxPackedCorpus

    ours, ref = PackedCorpus(pack_root, S), JaxPackedCorpus(pack_root, S)
    root = Path(frame_corpus)
    a = [str(root / "008MS" / f"frame_{i:05d}.jpg") for i in range(60)]
    b = [str(root / "009SS" / f"frame_{i:05d}.jpg") for i in range(60)]
    for fps in (a[3:19], a[::-7], a[10:12] + b[:3], a[5:6]):
        got, want = ours.get_seq(fps), ref.get_seq(fps)
        assert type(got) is np.ndarray and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)
    assert ours.get_seq(a[:3] + [str(root / "008MS" / "nope.jpg")]) is None
    assert ours.get_seq([str(root / "017EW" / "frame_00000.jpg")]) is None


def test_write_shard_from_frames(tmp_path):
    frames = np.random.default_rng(0).integers(0, 256, (5, 8, 8, 3), dtype=np.uint8)
    names = [f"f{i}.jpg" for i in range(5)]
    assert write_shard(str(tmp_path), "008MS", names, [frames[:3], frames[3:]], 8) == 5
    reader = PackedCorpus(str(tmp_path), 8)
    np.testing.assert_array_equal(reader.get_seq([f"/x/008MS/{n}" for n in names]), frames)
    assert reader.get("/x/008MS/other.jpg") is None
    assert json.loads((tmp_path / "008MS" / "frames_8.json").read_text())["names"] == names
    with pytest.raises(ValueError, match="4 frames written for 5 names"):
        write_shard(str(tmp_path), "009SS", names, [frames[:4]], 8)


def test_augmentations_match_jax():
    img = np.random.default_rng(1).integers(0, 256, (40, 52, 3), dtype=np.uint8)
    calls = [
        ("resize_shorter", (img, 24), {}),
        ("center_crop", (img, 24), {}),
        ("grayscale3", (img,), {}),
        ("gaussian_blur", (img, 1.3), {}),
        ("rotate", (img, 33.0), {}),
        ("normalize", (img,), {}),
    ]
    for name, args, kw in calls:
        np.testing.assert_array_equal(getattr(transforms, name)(*args, **kw),
                                      getattr(jax_transforms, name)(*args, **kw), err_msg=name)
    for name, args in (("random_resized_crop", (img, None, 24, (0.3, 1.0))),
                       ("color_jitter", (img, None, 0.4, 0.4, 0.4, 0.1))):
        outs = [getattr(mod, name)(args[0], np.random.default_rng(7), *args[2:])
                for mod in (transforms, jax_transforms)]
        np.testing.assert_array_equal(outs[0], outs[1], err_msg=name)
    for augs in ("n", "c", "cjbgo"):
        kw = dict(image_size=24, augs=augs, crop_size=24, crop_scale=(0.5, 1.0))
        a = transforms.FrameTransform(**kw)(img, np.random.default_rng(5))
        b = jax_transforms.FrameTransform(**kw)(img, np.random.default_rng(5))
        np.testing.assert_array_equal(a, b, err_msg=augs)


def test_index_math_matches_jax():
    items = list(range(500))
    for fn, args in (("get_fold", (items, 1, 3, 40)), ("get_fold", (items, 0, 3, None, 2)),
                     ("get_train_val_split", (items, 0.1)),
                     ("get_fpathseqlist", (items, 16, 1, 30)),
                     ("get_fpathseqlist", (items, 8, 2)),
                     ("get_fpath2framelist", (items, 50, 40))):
        assert getattr(indexing, fn)(*args) == getattr(jax_indexing, fn)(*args), fn
    assert indexing.get_group("g2") == jax_indexing.get_group("g2")
    assert indexing.get_group("gr", random.Random(4)) == jax_indexing.get_group(
        "gr", random.Random(4))
    assert indexing.AGE_GROUPS == jax_indexing.AGE_GROUPS


@pytest.mark.parametrize("drop_last", [True, False])
def test_epoch_sampler_matches_jax(drop_last):
    for n, b in ((23, 4), (3, 8), (64, 8)):
        got = EpochSampler(n, b, seed=2, drop_last=drop_last).batches(5)
        want = JaxEpochSampler(n, b, seed=2, drop_last=drop_last).batches(5)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_cpu_device_batches_are_fresh_tensors(frame_corpus):
    kw = _data_kw(frame_corpus, "videomae", "n")
    ds = make_dataset("videomae", DataConfig(**kw))["train"]
    host = list(DataLoader(ds, 4, seed=3, num_workers=2, to_device=False).epoch(0))
    loader = DataLoader(ds, 4, seed=3, num_workers=2, prefetch=1, max_batches=4,
                        device="cpu")
    assert len(loader) == 4
    batches = list(loader.epoch(0))
    assert len(batches) == 4
    for got, want in zip(batches, host):
        assert isinstance(got, torch.Tensor) and got.device == torch.device("cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    assert len({b.data_ptr() for b in batches}) == 4  # no buffer handed out twice
