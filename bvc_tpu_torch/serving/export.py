"""Serving export (counterpart of :mod:`bvc_tpu.serving.export`): freeze a
family's embedding function into an artifact directory that runs without
the port's model code.

- ``module.pt2``: the ``torch.export`` program of the extraction forward
  (:func:`torch.export.save`), weights included, batch-polymorphic by
  default so one artifact serves every batch size;
- ``meta.json``: family, model dims, feature dim, quantize mode, input
  signature, device.

The program embeds everything extraction runs: the uint8 -> normalized
conversion (clients send raw uint8 frames, a quarter of f32's bytes), the
family's pooling, and optionally the W8A8 path (:mod:`bvc_tpu_torch.ops.quant`)
with its int8 weights.  It holds the same aten operators as eager
extraction (no decompositions are run) and the port's kernels as the custom
operators ``bvc_tpu_torch::flash_fwd``, ``::gelu_poly``, ``::layer_norm``
(a bf16 ViT's two a block, and a JEPA encoder's final norm; on ``cuda``)
and ``::gemm_s8``, so loading it needs those operators registered
(:func:`load_artifact` imports :mod:`bvc_tpu_torch.ops.flash_attention`,
:mod:`bvc_tpu_torch.ops.gelu`, :mod:`bvc_tpu_torch.ops.layer_norm` and
:mod:`bvc_tpu_torch.ops.gemm`, and no model module) and, on ``cuda``, the
kernels built.

One device: the program is traced on the device it is exported for and
keeps that device in its constants (e.g. the ``torch.arange(...,
device=video.device)`` of VideoMAE's token indices), so an artifact
exported on ``cuda`` runs on ``cuda`` and one exported on ``cpu`` on the
CPU, where attention takes the plain path.  The JAX package's artifact is
serialized StableHLO with its parameters in ``params.npz``; here the
weights live inside ``module.pt2``.
"""

from __future__ import annotations

import collections
import copy
import json
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch import nn

from bvc_tpu_torch.utils.config import ModelConfig
from bvc_tpu_torch.utils.device import resolve_device

# the largest batch of a polymorphic artifact: tracing on CUDA guards the
# batch at 65535 (torch 2.11)
MAX_BATCH = 65535
_MODULE = "module.pt2"
_META = "meta.json"
_NAMESPACE = "bvc_tpu_torch"


class _EmbedCore(nn.Module):
    """``forward(video_uint8 [b, T, H, W, C]) -> [b, D]`` f32, the same
    math extraction runs (``evalbench/extract.py``): VideoMAE's and JEPA's
    ``embed`` (which normalize uint8 frames themselves); for SimCLR the last
    frame normalized, then the ResNet's pooled features (the extractor
    feeds it frames its readers normalized)."""

    def __init__(self, family: str, model: nn.Module, normalize: Callable):
        super().__init__()
        self.family = family
        self.model = model
        self.normalize = normalize

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        if self.family == "simclr":
            return self.model(self.normalize(video[:, -1]), with_head=False).float()
        return self.model.embed(video)


def kernel_ops(exported: torch.export.ExportedProgram) -> collections.Counter:
    """How many nodes of each ``bvc_tpu_torch`` custom operator the
    program holds, over its graph and every subgraph."""
    ops = collections.Counter()
    for module in exported.graph_module.modules():
        if not isinstance(module, torch.fx.GraphModule):
            continue
        for node in module.graph.nodes:
            name = node.target.name() if isinstance(node.target, torch._ops.OpOverload) else ""
            if name.startswith(_NAMESPACE + "::"):
                ops[name.split("::")[1].split(".")[0]] += 1
    return ops


def export_embed(family: str, model: nn.Module, cfg: ModelConfig, quantize: str = "none",
                 batch: int | None = None, device: str | torch.device | None = None
                 ) -> tuple[torch.export.ExportedProgram, dict]:
    """Export the family's embedding over ``model`` (a ``VideoMAEEncoder``,
    ``JEPAEncoder`` or ``ResNet``, e.g. from
    :func:`~bvc_tpu_torch.evalbench.extract.load_family_model`) on
    ``device`` (``cuda`` when None).

    Returns ``(exported, meta)``: the ``torch.export.ExportedProgram`` and
    the metadata dict.  ``batch=None`` exports a symbolic batch dimension
    (one artifact, any batch from 1 to :data:`MAX_BATCH`); an int pins it.
    ``quantize='int8'`` freezes the W8A8 weights of the expansion matmuls
    into the artifact (the ViT families only, the path of
    ``compute_embeddings --quantize int8``).  The caller's model is left as
    it was: a copy is quantized, moved and put in eval mode, and the export
    runs under ``torch.no_grad()``.
    """
    from bvc_tpu_torch.evalbench.extract import _check_quantize
    from bvc_tpu_torch.models.videomae import normalize_on_device
    from bvc_tpu_torch.ops.quant import quantize_encoder

    if family not in ("videomae", "jepa", "simclr"):
        raise ValueError(f"unknown family {family!r}")
    if family != "simclr" and cfg.architecture == "hiera":
        raise ValueError("export_serving: architecture 'hiera' is not exported: the serving "
                         "entry embeds a VideoMAE encoder, and no artifact path is built for "
                         "Hiera's unrolled stages")
    if family != "simclr" and cfg.pos_embed == "rope3d":
        raise ValueError("export_serving: pos_embed='rope3d' is not exported: a loaded "
                         "artifact registers the flash, GELU and GEMM operators, not the "
                         "bvc_tpu_torch::rope3d operator its blocks would call")
    quantized = _check_quantize(family, quantize)
    device = resolve_device(device)
    model = copy.deepcopy(model)
    if quantized:
        # on the CPU, as extraction quantizes after loading: CUDA divides by
        # a scalar through its reciprocal, which moves some int8 weights by one
        model = quantize_encoder(model.cpu())
    core = _EmbedCore(family, model.to(device).eval(), normalize_on_device)
    b = 2 if batch is None else int(batch)
    video = torch.zeros((b, cfg.num_frames, cfg.image_size, cfg.image_size, cfg.in_channels),
                        dtype=torch.uint8, device=device)
    dynamic = (None if batch is not None
               else {"video": {0: torch.export.Dim("b", min=1, max=MAX_BATCH)}})
    with torch.no_grad():
        exported = torch.export.export(core, (video,), dynamic_shapes=dynamic, strict=False)
    meta = {
        "family": family,
        "feature_dim": model.feature_dim if family == "simclr" else cfg.hidden_size,
        "quantize": "int8" if quantized else "none",
        "batch": "polymorphic" if batch is None else int(batch),
        "num_frames": cfg.num_frames,
        "image_size": cfg.image_size,
        "tubelet_size": cfg.tubelet_size,
        "architecture": cfg.architecture,
        "input": "uint8 [b, num_frames, image_size, image_size, 3] "
                 "(raw frames; normalization is inside the module)",
        "platforms": [device.type],
        "n_leaves": sum(1 for _ in core.parameters()) + sum(1 for _ in core.buffers()),
    }
    return exported, meta


def save_artifact(out_dir: str | Path, exported: torch.export.ExportedProgram,
                  meta: dict) -> str:
    """Write the artifact directory (``module.pt2`` with the weights inside
    it, and ``meta.json``; there is no ``params.npz``); returns its path."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, out / _MODULE)
    (out / _META).write_text(json.dumps(meta, indent=1))
    return str(out)


def load_artifact(path: str | Path, device: str | torch.device | None = None) -> Callable:
    """Artifact directory -> ``fn(video_uint8) -> np.ndarray [b, D]``.

    Runs on ``device`` (``cuda`` when None), which must be the device the
    artifact was exported for (``meta["platforms"]``).  Imports the port's
    operator registrations and no model module: the computation
    (normalization, pooling, any int8 dequant) replays from the program.  On
    ``cuda`` the kernels the program calls are built before this returns.
    ``fn`` runs under ``torch.inference_mode()``; a pinned artifact called
    at another batch raises.  ``fn.feature_dim`` and ``fn.meta`` carry the
    sidecar.
    """
    from bvc_tpu_torch.ops import _build, flash_attention, gelu, gemm, layer_norm

    device = resolve_device(device)
    p = Path(path)
    meta = json.loads((p / _META).read_text())
    if [device.type] != meta["platforms"]:
        raise ValueError(f"artifact {p} was exported for {meta['platforms']} and runs there "
                         f"only, not on {device}: an artifact is traced for one device")
    exported = torch.export.load(p / _MODULE)
    if device.type == "cuda":
        libraries = {**flash_attention.OP_LIBRARIES, **gelu.OP_LIBRARIES, **gemm.OP_LIBRARIES,
                     **layer_norm.OP_LIBRARIES}
        _build.build_all(sorted({libraries[op] for op in kernel_ops(exported)}))
    module = exported.module()

    @torch.inference_mode()
    def fn(video) -> np.ndarray:
        x = torch.as_tensor(np.asarray(video, np.uint8)).to(device)
        return module(x).cpu().numpy()

    fn.feature_dim = meta["feature_dim"]  # type: ignore[attr-defined]
    fn.meta = meta  # type: ignore[attr-defined]
    return fn
