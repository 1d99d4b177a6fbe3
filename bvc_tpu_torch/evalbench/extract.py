"""Embedding extraction (counterpart of :mod:`bvc_tpu.evalbench.extract`).

Load a VideoMAE, JEPA or SimCLR checkpoint (or build a random model), run
the family's embedding over a dataset of ``(clip, fname)`` samples (the
benchmark readers of :func:`make_task_dataset`), and write
``embeddings_{run_id}.csv`` under the reference's CSV contract: sorted by
fname, deduplicated, the test split under ``savedir/test/``.

- VideoMAE: ``LayerNorm(mean(tokens))`` of the encoder, from a
  ``model_{run_id}.pth.tar`` in the HF layout (``model_state_dict``);
- JEPA: the mean over the tokens of the normed online encoder
  (:meth:`JEPAEncoder.embed`), from the ``encoder`` entry of a
  ``.pth.tar`` in the reference ``VisionTransformer`` layout; the EMA
  target is not used for embeddings, as in the reference;
- SimCLR: the ResNet's pooled features of the last frame only, head
  stripped, BatchNorm in eval mode (its running statistics), f32
  (:meth:`~bvc_tpu_torch.models.resnet.ResNet.embed`), from a
  ``model_state_dict`` in torchvision names.  In f32 the convolutions run
  on cuDNN, which may use TF32 under ``torch.backends.cudnn.allow_tf32``
  (PyTorch's default is True, as XLA's default precision on a GPU); this
  module leaves that global setting to the caller: set it False for full
  f32 products.

The layouts are what ``bvc_tpu/cli/export_torch.py`` writes, and what the
port's own trainers write (``bvc_tpu_torch.training``); Orbax checkpoints
need JAX and are not read here.  ``quantize="int8"`` takes the W8A8 path of
the ViT families (:mod:`bvc_tpu_torch.ops.quant`: the blocks' qkv and fc1
quantized after the weights load, their products on the s8 kernel of
``csrc/gemm.cu``); SimCLR's conv trunk is refused, and so is int8 on a
``seq`` mesh.

Data parallel (a process group of several ranks): every rank holds the
whole model on its own GPU and embeds its strided slice of the dataset,
``idxs[rank::world]``; every rank gathers the rows with
:func:`~bvc_tpu_torch.parallel.all_gather_objects`, and the callers write
them on rank 0.  Sequence-parallel
extraction comes with slice 7c of the port.
"""

from __future__ import annotations

import concurrent.futures as cf
from pathlib import Path
from typing import Callable

import numpy as np
import pandas as pd
import torch

from bvc_tpu_torch.evalbench.datasets import (Cifar10Dataset, SSv2Dataset, ToyboxDataset,
                                              UCF101Dataset, drop_none_collate)
from bvc_tpu_torch.models.convert import (jepa_encoder_from_reference_state_dict,
                                          resnet_from_torchvision_state_dict,
                                          videomae_from_hf_state_dict)
from bvc_tpu_torch.models.jepa import JEPAEncoder
from bvc_tpu_torch.models.resnet import ResNet
from bvc_tpu_torch.models.videomae import VideoMAEEncoder
from bvc_tpu_torch.ops.quant import quantize_encoder
from bvc_tpu_torch.parallel.collectives import all_gather_objects
from bvc_tpu_torch.parallel.mesh import data_rank, data_size
from bvc_tpu_torch.utils.config import ModelConfig
from bvc_tpu_torch.utils.device import resolve_device


def make_task_dataset(ds_task: str, vid_root: str, frame_rate: int, sample_len: int,
                      train: bool, image_size: int = 224, annotation_path: str = "",
                      fold: int = 1):
    """The benchmark reader of ``ds_task`` (ssv2, toybox / tb_cat /
    tb_trans, ucf101, cifar10), as the JAX package builds it."""
    if ds_task == "ssv2":
        return SSv2Dataset(vid_root, frame_rate, sample_len, train, image_size)
    if ds_task in ("toybox", "tb_cat", "tb_trans"):
        return ToyboxDataset(vid_root, frame_rate, sample_len, image_size)
    if ds_task == "ucf101":
        # fold plumbed through like the reference's UCF101(fold=...)
        # (benchmarks/dsdatasets.py:238)
        return UCF101Dataset(vid_root, annotation_path or str(Path(vid_root).parent
                                                              / "ucfTrainTestlist"),
                             fold=fold, train=train, sample_len=sample_len,
                             frame_rate=frame_rate, image_size=image_size)
    if ds_task == "cifar10":
        return Cifar10Dataset(vid_root, sample_len, train, image_size)
    raise ValueError(f"unknown ds_task {ds_task!r}")


def _simclr_model(cfg: ModelConfig, head_dim: int = 512, seed: int = 0) -> ResNet:
    # f32, as the JAX package's extraction applies the ResNet
    return ResNet(cfg.architecture or "resnet18", head_dim, dtype=torch.float32, seed=seed)


_ENCODERS = {"videomae": VideoMAEEncoder, "jepa": JEPAEncoder}


def _encoder_class(family: str) -> type[torch.nn.Module]:
    if family not in _ENCODERS:
        raise ValueError(f"unknown family {family!r}")
    return _ENCODERS[family]


def _check_quantize(family: str, quantize: str | None,
                    mesh_shape: dict[str, int] | None = None) -> bool:
    """Validate the ``quantize`` option; True for the int8 path.  ``"none"``,
    ``""`` and None mean off; SimCLR's conv trunk and a ``seq`` mesh (the
    ring re-slices the blocks' parameters) are refused rather than run
    unquantized; a data mesh runs it."""
    if quantize in ("none", "", None):
        return False
    if quantize != "int8":
        raise ValueError(f"unknown quantize mode {quantize!r} "
                         "(expected 'none' or 'int8')")
    if family == "simclr":
        raise ValueError("quantize='int8' covers the ViT families "
                         "(videomae, jepa); the resnet conv trunk is "
                         "not quantized")
    if "seq" in (mesh_shape or {}):
        raise ValueError("quantize='int8' does not compose with "
                         "sequence-parallel extraction; use a pure-data "
                         "mesh")
    return True


def _embed_fn(model: VideoMAEEncoder | JEPAEncoder | ResNet, device: torch.device
              ) -> Callable:
    """``fn(video_batch) -> [B, D]`` f32 numpy; ``fn.model`` is the module
    (in eval mode), ``fn.feature_dim`` the embedding width."""
    model = model.to(device).eval()
    # SimCLR reads the last frame only: the others stay on the host
    frames = slice(-1, None) if isinstance(model, ResNet) else slice(None)

    @torch.inference_mode()
    def fn(video) -> np.ndarray:
        x = torch.as_tensor(np.asarray(video)[:, frames]).to(device)
        return model.embed(x).cpu().numpy()

    fn.model = model
    fn.feature_dim = model.feature_dim if isinstance(model, ResNet) else model.cfg.hidden_size
    return fn


def load_family_model(family: str, ckpt_path: str, cfg: ModelConfig) -> torch.nn.Module:
    """The model a family embeds with, on the CPU in f32, with the weights
    of a ``.pth.tar`` checkpoint: one account of each family's checkpoint
    keys, shared by :func:`make_embed_fn` and the serving exporter
    (:mod:`bvc_tpu_torch.serving`).  VideoMAE: ``model_state_dict`` in HF
    names; JEPA: the online ``encoder`` in the reference layout, else
    ``target_encoder`` (as the JAX package reads it); SimCLR:
    ``model_state_dict`` in torchvision names, running statistics
    included."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if family == "simclr":
        sd = resnet_from_torchvision_state_dict(ckpt["model_state_dict"])
        model = _simclr_model(cfg, head_dim=sd["fc.0.weight"].shape[0])
    else:
        model = _encoder_class(family)(cfg)
        if family == "jepa":
            enc = ckpt["encoder"] if "encoder" in ckpt else ckpt["target_encoder"]
            sd = jepa_encoder_from_reference_state_dict(enc, cfg)
        else:
            sd = videomae_from_hf_state_dict(ckpt["model_state_dict"], cfg)
    model.load_state_dict(sd)
    return model


def init_family_model(family: str, cfg: ModelConfig, seed: int = 0) -> torch.nn.Module:
    """The model a family embeds with, random from ``seed``, on the CPU."""
    if family == "simclr":
        return _simclr_model(cfg, seed=seed)
    return _encoder_class(family)(cfg, seed=seed)


def make_embed_fn(family: str, ckpt_path: str, cfg: ModelConfig,
                  device: str | torch.device | None = None,
                  quantize: str | None = "none",
                  mesh_shape: dict[str, int] | None = None) -> Callable:
    """Load a checkpoint's model (:func:`load_family_model`) and return the
    embedding function on ``device`` (``cuda`` when None; the rank's GPU
    under a process group); ``quantize="int8"`` quantizes the loaded blocks
    (see :func:`_check_quantize`, which reads the run's ``mesh_shape``)."""
    q = _check_quantize(family, quantize, mesh_shape)
    device = resolve_device(device)
    model = load_family_model(family, ckpt_path, cfg)
    return _embed_fn(quantize_encoder(model) if q else model, device)


def untrained_embed_fn(family: str, cfg: ModelConfig, seed: int = 0,
                       device: str | torch.device | None = None,
                       quantize: str | None = "none",
                       mesh_shape: dict[str, int] | None = None) -> Callable:
    """Random-init model from ``seed``: the stage-0 untrained baseline;
    ``quantize="int8"`` quantizes its blocks."""
    q = _check_quantize(family, quantize, mesh_shape)
    device = resolve_device(device)
    model = init_family_model(family, cfg, seed)
    return _embed_fn(quantize_encoder(model) if q else model, device)


def save_results(fnames: list[str], embeddings: np.ndarray, phase: str,
                 run_id: str, savedir: str) -> str:
    """CSV contract of the reference ``save_results``."""
    hdim = embeddings.shape[1]
    cols = [f"dim{i}" for i in range(hdim)]
    df = pd.DataFrame(embeddings, columns=cols)
    df["fnames"] = fnames
    df = df[["fnames"] + cols].sort_values("fnames")
    df = df.drop_duplicates(subset="fnames", ignore_index=True)
    out_dir = Path(savedir) / ("test" if phase == "test" else "")
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"embeddings_{run_id}.csv"
    df.to_csv(path, sep=",", float_format="%.6f", index=False)
    return str(path)


def _clip_shape(dataset) -> tuple[int, ...]:
    """The shape of a readable sample's clip, from the first 16 (the
    readers return ``(None, None)`` for an unreadable one)."""
    for i in range(min(len(dataset), 16)):
        clip = dataset[i][0]
        if clip is not None:
            return np.asarray(clip).shape
    raise RuntimeError("no readable sample in the first 16: cannot build the dummy batch "
                       "of a rank whose chunk is empty")


def extract_embeddings(embed_fn: Callable, dataset, batch_size: int = 64,
                       num_workers: int = 6) -> tuple[list[str], np.ndarray]:
    """Run ``embed_fn`` over the whole dataset in batches of ``batch_size``.

    Samples are read by a thread pool; unreadable ones (clip None) are
    dropped.  The short last batch runs as it is: the JAX package pads it
    only to a multiple of the device count, which is one a rank here.
    Under a process group each data rank embeds ``idxs[rank::world]`` of
    the mesh's ``data`` axis (the ``model`` ranks of a data row embed the
    same samples); the count of calls comes from the global n, so every
    rank makes the same number (a rank whose chunk is empty or unreadable
    embeds a one-clip dummy batch and keeps no row), and the rows of every
    data rank are gathered in data order (:func:`merge_gathered`).
    """
    fnames: list[str] = []
    embs: list[np.ndarray] = []
    n, world = len(dataset), data_size()
    idxs = list(range(n))[data_rank()::world]
    largest_slice = -(-n // world)
    n_iters = -(-largest_slice // batch_size)
    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        for it in range(n_iters):
            chunk = idxs[it * batch_size:(it + 1) * batch_size]
            clips, names = drop_none_collate(list(pool.map(lambda i: dataset[i], chunk)))
            if not names:
                if world > 1:  # keep the ranks' calls in step
                    embed_fn(np.zeros((1, *_clip_shape(dataset)), np.float32))
                continue
            fnames += names
            embs.append(np.asarray(embed_fn(clips), dtype=np.float32))
    local = {
        "fnames": fnames,
        "embeddings": np.concatenate(embs) if embs
        else np.zeros((0, getattr(embed_fn, "feature_dim", 1)), np.float32),
    }
    return merge_gathered(all_gather_objects(local))


def merge_gathered(gathered) -> tuple[list[str], np.ndarray]:
    """Merge per-process ``{'fnames', 'embeddings'}`` dicts; empty blocks
    (whose placeholder width may differ) are dropped when any process has
    rows, and otherwise the widest placeholder width is kept."""
    all_names: list[str] = []
    all_embs: list[np.ndarray] = []
    for d in gathered:
        all_names += list(d["fnames"])
        all_embs.append(np.asarray(d["embeddings"]))
    non_empty = [e for e in all_embs if e.shape[0]]
    if non_empty:
        return all_names, np.concatenate(non_empty)
    dim = max((e.shape[1] for e in all_embs), default=1)
    return all_names, np.zeros((0, dim), np.float32)
