"""Dataset factories per trainer family, plus the complexity-matched
control conditions (a copy of :mod:`bvc_tpu.data.factory`).

Mirrors the three ``make_dataset`` variants
(``generative/homeview.py:17-79``, ``predictive/pretrain_jepa.py:51-82``,
``contrastive/pretrain_simclr.py:43-69``) and
``controls.make_dataset_spatial`` (``generative/controls.py:30-112``) on
top of one shared index-math module.
"""

from __future__ import annotations

import pickle
import random as _random
from pathlib import Path

from bvc_tpu_torch.data.datasets import (
    ClipDataset,
    PairDataset,
    StillVideoDataset,
    TwoSeqDataset,
)
from bvc_tpu_torch.data.indexing import (
    get_fold,
    get_fpath2framelist,
    get_fpathlist,
    get_fpathseqlist,
    get_group,
    get_train_val_split,
)
from bvc_tpu_torch.data.transforms import FrameTransform
from bvc_tpu_torch.utils.config import DataConfig

MAX_VAL_SAMPLES = 10000  # generative/homeview.py:67


def _corpus(cfg: DataConfig, rng: _random.Random) -> list[str]:
    """Concatenated, fold-filtered frame list for the configured group."""
    group = get_group(cfg.train_group, rng)
    if group is None:
        raise ValueError(f"unknown train_group {cfg.train_group!r}")
    fps: list[str] = []
    missing = []
    for subj in group:
        if not (Path(cfg.jpg_root) / subj).is_dir():
            missing.append(subj)  # tolerate partial corpora (smoke runs)
            continue
        fps += get_fpathlist(cfg.jpg_root, subj, ds_rate=cfg.ds_rate)
    if missing:
        import warnings

        warnings.warn(f"subject dirs missing under {cfg.jpg_root}: {missing}")
    if not fps:
        raise FileNotFoundError(f"no frames found for group {cfg.train_group} under {cfg.jpg_root}")
    return get_fold(fps, cfg.fold, cfg.num_folds, segment_size=cfg.segment_size)


# Conditions that read the pre-pickled control seqlists
# (pretrain_videomae.py:216-219); 'static' joins them when a control root
# is configured (StillVideoDataset lives inside make_dataset_spatial).
CONTROL_CONDITIONS = ("MatchedSpatial", "MatchedSpatioTemporal")


def make_generative_dataset(cfg: DataConfig) -> dict:
    """Clip dataset for VideoMAE (``generative/homeview.py:17-79``):
    fold → optional val split (middle slice) → stride-resampled clips."""
    rng = _random.Random(cfg.seed)
    # Only the spatial-matched conditions take the pickled-seqlist path
    # (pretrain_videomae.py:216-219); MatchedTemporal runs the normal
    # dataset with num_frames=1 from the preset.  'static' additionally
    # routes here when a control root is configured (the reference's
    # StillVideoDataset path, live only inside make_dataset_spatial).
    if cfg.condition in CONTROL_CONDITIONS or (
        cfg.condition == "static" and cfg.control_data_root
    ):
        return make_control_dataset(cfg)
    fps = _corpus(cfg, rng)
    transform = FrameTransform(image_size=cfg.image_size, output_uint8=cfg.feed_uint8)
    val_ratio = 0.1 if cfg.keep_val else 0.0
    if val_ratio == 0:
        train_fp, val_fp = fps, []
    else:
        train_fp, val_fp = get_train_val_split(fps, val_ratio)
    n_val = min(int(len(val_fp) / cfg.num_frames), MAX_VAL_SAMPLES)
    shuffle_frames = cfg.condition == "shuffle"
    train = ClipDataset(
        get_fpathseqlist(train_fp, cfg.num_frames, ds_rate=1, n_samples=cfg.n_trainsamples),
        transform, shuffle_frames=shuffle_frames,
    )
    val = None
    if n_val > 0:
        val = ClipDataset(
            get_fpathseqlist(val_fp, cfg.num_frames, ds_rate=1, n_samples=n_val),
            transform,
        )
    return {"train": train, "val": val}


def make_predictive_dataset(cfg: DataConfig) -> dict:
    """Pairs (tubelet 1) or two-tubelet sequences for JEPA
    (``pretrain_jepa.py:51-82``)."""
    rng = _random.Random(cfg.seed)
    fps = _corpus(cfg, rng)
    if cfg.condition == "shuffle":
        rng.shuffle(fps)
    transform = FrameTransform(
        image_size=cfg.image_size, augs=cfg.augs,
        crop_size=cfg.image_size, crop_scale=(1.0, 1.0),
        output_uint8=cfg.feed_uint8,
    )
    if cfg.tubelet_size == 1:
        train = PairDataset(
            get_fpath2framelist(fps, cfg.interval, n_samples=cfg.n_trainsamples),
            transform,
        )
    else:
        train = TwoSeqDataset(fps, transform, cfg.interval, cfg.tubelet_size)
    return {"train": train, "val": None}


def make_contrastive_dataset(cfg: DataConfig) -> dict:
    """Frame pairs for SimCLR with crop_scale (0.7, 1.0)
    (``pretrain_simclr.py:43-69``)."""
    rng = _random.Random(cfg.seed)
    fps = _corpus(cfg, rng)
    if cfg.condition == "shuffle":
        rng.shuffle(fps)
    transform = FrameTransform(
        image_size=cfg.image_size, augs=cfg.augs,
        crop_size=cfg.image_size, crop_scale=(0.7, 1.0),
        output_uint8=cfg.feed_uint8,
    )
    train = PairDataset(
        get_fpath2framelist(fps, cfg.interval, n_samples=cfg.n_trainsamples),
        transform,
    )
    return {"train": train, "val": None}


def load_control_seqlist(cfg: DataConfig) -> list[list[str]]:
    """Pre-pickled path-seq lists for the Matched* conditions
    (``controls.py:44-58``): ``{control_data_root}/{group}_samples.pkl``
    with relative paths that get ``jpg_root`` prepended."""
    pkl = Path(cfg.control_data_root) / f"{cfg.train_group}_samples.pkl"
    with open(pkl, "rb") as f:
        seqlist = pickle.load(f)
    return [[cfg.jpg_root + el for el in seq] for seq in seqlist]


def make_control_dataset(cfg: DataConfig) -> dict:
    """Complexity-matched controls (``controls.make_dataset_spatial``):
    pickled seqlists → fold → 0.1 val split → random.sample → dataset;
    'static' condition swaps in StillVideoDataset for train."""
    rng = _random.Random(cfg.seed)
    seqlist = load_control_seqlist(cfg)
    seqlist = get_fold(seqlist, cfg.fold, cfg.num_folds, segment_size=cfg.segment_size)
    transform = FrameTransform(image_size=cfg.image_size, output_uint8=cfg.feed_uint8)
    train_fp, val_fp = get_train_val_split(seqlist, val_ratio=0.1)
    n_val = min(len(val_fp), MAX_VAL_SAMPLES)
    train_fp = rng.sample(train_fp, min(cfg.n_trainsamples, len(train_fp)))
    val_fp = rng.sample(val_fp, n_val) if n_val else []
    if cfg.condition == "static":
        train = StillVideoDataset(train_fp, transform, num_frames=16)
    else:
        train = ClipDataset(train_fp, transform)
    val = ClipDataset(val_fp, transform) if val_fp else None
    return {"train": train, "val": val}


FACTORIES = {
    "videomae": make_generative_dataset,
    "generative": make_generative_dataset,
    "jepa": make_predictive_dataset,
    "predictive": make_predictive_dataset,
    "simclr": make_contrastive_dataset,
    "contrastive": make_contrastive_dataset,
}


def make_dataset(family: str, cfg: DataConfig) -> dict:
    dsets = FACTORIES[family](cfg)
    if cfg.pack_root:
        # packed-corpus fast path (bvc_tpu/data/packed.py): plain
        # transforms read pre-resized uint8 memmap rows instead of
        # decoding JPEGs; augmented transforms ignore the reader
        from bvc_tpu_torch.data.packed import PackedCorpus

        reader = PackedCorpus(cfg.pack_root, cfg.image_size)
        for ds in dsets.values():
            if ds is not None:
                ds.reader = reader
    return dsets
