"""Gradient-health probes (counterpart of :mod:`bvc_tpu.training.probes`).

The reference's ``grad_logger`` reads the gradient norms of a few named
layers: three VideoMAE ones, JEPA's first and last encoder ``qkv`` weights,
or SimCLR's ``conv1`` and ``fc.0``; the JAX package adds the global norm and
takes them all from one pass over the gradients.  So does this: one
per-tensor norm per parameter (``torch._foreach_norm``, one multi-tensor
pass on the device), combined into the metrics, which stay device tensors.

The opt-in grad-stats table (``--log_grad_stats y``): :func:`full_grad_probes`
gives a family's extra probes, the mean, least and largest of a set of
per-layer gradient norms (the reference meter's ``avg (min, max)``), and
:func:`format_gstats` the log line's suffix.  The sets are the JAX
package's: VideoMAE's patch embedding, ``enc_to_dec`` and decoder head;
every JEPA weight (:func:`per_layer_weight_norms`); SimCLR's stem
convolution and its head's first layer.

Under a split layout (``fsdp``: ``DTensor`` shards over the ``data``
ranks; ``tp``: the heads' parts over the ``model`` ranks) a rank holds part
of some gradients: each rank sums the squares of its parts, one all-reduce
a group adds the sums of the split tensors over their ranks, and a tensor
every rank holds whole counts once, so every probe reads one process's
value.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from bvc_tpu_torch.parallel.sharding import local_tensor, shard_group


def _sumsqs(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Squared norms in f32: one multi-tensor pass on the card; on the CPU a
    cascade sum of squares per tensor, since the CPU's norm kernels sum a
    large tensor less exactly (4e-5 relative at 2.4M entries)."""
    tensors = [t.float() for t in tensors]
    if tensors and tensors[0].is_cuda:
        return [x.square() for x in torch._foreach_norm(tensors)]
    return [t.square().sum() for t in tensors]


def _whole_sumsqs(params: list[torch.Tensor], grads: list[torch.Tensor]
                  ) -> list[torch.Tensor]:
    """The squared norms of the whole ``grads`` (each in its parameter's
    layout): the rank's parts' sums, added over the ranks of each split
    tensor's group in one all-reduce a group."""
    sums = _sumsqs([local_tensor(g) for g in grads])
    split: dict = {}
    for i, p in enumerate(params):
        is_split, group = shard_group(p)
        if is_split:
            split.setdefault(group, []).append(i)
    for group, idx in split.items():
        total = torch.stack([sums[i] for i in idx])
        dist.all_reduce(total, group=group)
        for j, i in enumerate(idx):
            sums[i] = total[j]
    return sums


def _grad_sumsqs(model: torch.nn.Module, select: Callable[[str, torch.Tensor], bool]
                 = lambda name, p: True) -> list[tuple[str, torch.Tensor]]:
    """(name, squared gradient norm) of every selected parameter with a
    gradient."""
    named = [(n, p) for n, p in model.named_parameters()
             if p.grad is not None and select(n, p)]
    return list(zip([n for n, _ in named],
                    _whole_sumsqs([p for _, p in named], [p.grad for _, p in named])))


def _norm_of(sumsqs: list[tuple[str, torch.Tensor]], prefix: str, device) -> torch.Tensor:
    """The norm over the entries whose name starts with ``prefix``: the
    global norm of one module's gradients."""
    parts = [s for n, s in sumsqs if n.startswith(prefix)]
    return torch.stack(parts).sum().sqrt() if parts else torch.zeros((), device=device)


def videomae_grad_sumsqs(model: torch.nn.Module,
                         select: Callable[[str, torch.Tensor], bool] = lambda name, p: True
                         ) -> dict[str, torch.Tensor]:
    """The squares of :func:`videomae_grad_metrics`' norms over the
    selected parameters with a gradient (a pipeline stage adds its own to
    the other stages', :mod:`bvc_tpu_torch.parallel.pipeline`)."""
    last = f"encoder.blocks.layers.{model.cfg.depth - 1}."
    parts = {"grad_norm": [], "grad_efl": [], "grad_ell": [], "grad_dll": []}
    for name, s in _grad_sumsqs(model, select):
        parts["grad_norm"].append(s)
        if name.startswith("encoder.patch_embed."):
            parts["grad_efl"].append(s)
        elif name.startswith(last):
            parts["grad_ell"].append(s)
        elif name.startswith("decoder_head."):
            parts["grad_dll"].append(s)
    device = next(model.parameters()).device
    return {k: torch.stack(v).sum() if v else torch.zeros((), device=device)
            for k, v in parts.items()}


def videomae_grad_metrics(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """``grad_norm`` over every parameter with a gradient, and the norms of
    the patch embedding (``grad_efl``), the last encoder layer
    (``grad_ell``) and the decoder head (``grad_dll``) of a
    :class:`~bvc_tpu_torch.models.videomae.VideoMAEPretrain`."""
    return {k: v.sqrt() for k, v in videomae_grad_sumsqs(model).items()}


def jepa_grad_metrics(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """``grad_norm`` over every parameter with a gradient, and the norms of
    the first (``grad_fl``) and last (``grad_ll``) encoder layer's ``qkv``
    weight of a :class:`~bvc_tpu_torch.models.jepa.JEPA`."""
    sumsqs = _grad_sumsqs(model)
    device = next(model.parameters()).device
    zero = torch.zeros((), device=device)
    last = len(model.encoder.blocks.layers) - 1
    by_name = dict(sumsqs)
    return {"grad_norm": torch.stack([s for _, s in sumsqs]).sum().sqrt() if sumsqs else zero,
            "grad_fl": by_name.get("encoder.blocks.layers.0.qkv.weight", zero).sqrt(),
            "grad_ll": by_name.get(f"encoder.blocks.layers.{last}.qkv.weight", zero).sqrt()}


def simclr_grad_metrics(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """``grad_norm`` over every parameter with a gradient, and the norms of
    the stem convolution (``grad_conv1``) and of the head's first layer,
    weight and bias (``grad_fc0``), of a
    :class:`~bvc_tpu_torch.models.resnet.ResNet`."""
    sumsqs = _grad_sumsqs(model)
    device = next(model.parameters()).device
    return {"grad_norm": _norm_of(sumsqs, "", device),
            "grad_conv1": _norm_of(sumsqs, "conv1.", device),
            "grad_fc0": _norm_of(sumsqs, "fc.0.", device)}


def per_layer_weight_norms(model: torch.nn.Module) -> torch.Tensor:
    """The gradient norm of every weight: each parameter of at least 2
    dimensions with no ``bias`` in its name (the reference's ``len(p.shape)
    > 1`` filter), one norm per layer since each layer's weights are tensors
    of their own.  LayerNorm scales are out, JEPA's ``mask_token`` is in; a
    weight with no gradient counts 0, as the JAX package's zero gradient."""
    weights = [(n, p) for n, p in model.named_parameters() if p.ndim >= 2 and "bias" not in n]
    if not weights:
        return torch.zeros((1,), device=next(model.parameters()).device)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for _, p in weights]
    return torch.stack(_whole_sumsqs([p for _, p in weights], grads)).sqrt()


def _meter(norms_fn: Callable[[torch.nn.Module], torch.Tensor]
           ) -> dict[str, Callable[[torch.nn.Module], torch.Tensor]]:
    """avg/min/max over a set of per-layer norms: the reference
    ``AverageMeter``'s fields that its log lines read."""
    return {"gstat_avg": lambda m: norms_fn(m).mean(),
            "gstat_min": lambda m: norms_fn(m).min(),
            "gstat_max": lambda m: norms_fn(m).max()}


def _module_norms(prefixes: tuple[str, ...]) -> Callable[[torch.nn.Module], torch.Tensor]:
    def norms(model: torch.nn.Module) -> torch.Tensor:
        sumsqs = _grad_sumsqs(model, lambda n, p: n.startswith(prefixes))
        device = next(model.parameters()).device
        return torch.stack([_norm_of(sumsqs, pre, device) for pre in prefixes])

    return norms


def full_grad_probes(family: str) -> dict[str, Callable[[torch.nn.Module], torch.Tensor]]:
    """The opt-in grad-stats table of one model family: extra probes (name
    -> fn(model), read after the backward) for a step's ``grad_probes``."""
    if family == "videomae":
        return _meter(_module_norms(("encoder.patch_embed.", "enc_to_dec.", "decoder_head.")))
    if family == "jepa":
        # every weight of encoder and predictor, as the reference's meter
        return _meter(per_layer_weight_norms)
    if family == "simclr":
        return _meter(_module_norms(("conv1.", "fc.0.")))
    raise ValueError(f"unknown family {family!r}")


def format_gstats(metrics) -> str:
    """The log line's suffix of the grad-stats table (the reference meter's
    ``avg (min, max)``, ``loggingtools.py:98-119``), empty when the step ran
    no probe.  Shared by the three trainers."""
    if "gstat_avg" not in metrics:
        return ""
    return " [grad: %.2e (%.2e, %.2e)]" % (float(metrics["gstat_avg"]),
                                            float(metrics["gstat_min"]),
                                            float(metrics["gstat_max"]))
