"""Sequence (time) parallel VideoMAE training and VideoMAE / V-JEPA
extraction (counterpart of :mod:`bvc_tpu.parallel.seqpar`).

The time axis of a clip is split over the ``seq`` ranks of the process's
mesh (:func:`~bvc_tpu_torch.parallel.mesh.make_mesh` with a ``seq``
axis): each rank of a ring holds its data block's clips, frames
``[t0 * tubelet, t1 * tubelet)`` (:func:`time_slice`), whose tokens are a
contiguous run of the t-major token order, so a rank's positions are the
tables' rows from its first token on.  Per rank the step runs patchify,
the encoder on its visible tokens, the decoder over its grid and the
norm-pix loss on its own sheets; the only communication across the ring
is the attention (:func:`~bvc_tpu_torch.ops.attention.multi_head_attention`
with ``impl='ring:seq'``: the flash kernels once per hop,
:mod:`bvc_tpu_torch.ops.ring_attention`) and the gradients' mean.

Exactness is structural, as in the JAX package: the tube mask draws one
spatial mask a clip and tiles it over every sheet, so every rank keeps the
same static count of visible tokens; attention sees the same global keys;
the norm-pix targets are per patch; equal masked counts make the mean of
the ranks' mean losses the global mean.

The gradients are averaged once a step, over the gradient group (the
``data`` x ``seq`` ranks that share a ``model`` coordinate: JAX ``pmean``s
them over ``(data, seq)``), by ``DistributedDataParallel`` over that group
(:meth:`~bvc_tpu_torch.parallel.mesh.Mesh.gradient_group`, which
:class:`~bvc_tpu_torch.training.state.TrainState` wraps the model in).  The
ring's backward already brings every block's dK and dV home, so a rank's
gradient is that of its own loss through every rank's queries: no other
reduction may touch the parameters (JAX hit the same double count).
``zero1`` partitions the optimizer state over ``data`` as on a data mesh.

Seq x TP (:func:`make_seq_tp_videomae_train_step`, ``--mesh
data=D,seq=S,model=M``): the blocks hold their ``model`` rank's heads
(7b's :meth:`~bvc_tpu_torch.models.vit.Block.split_heads`, Megatron's two
operators over the ``model`` group) and run the ring on those heads.  As
in the JAX package, the ``--param_sharding`` flag stays ``replicated``;
the port stores the head parts as 7b does, and checkpoints hold whole
tensors.

JAX's ``require_process_local_seq`` has no counterpart: a JAX process
feeds whole-time-axis batches to its devices, while here each rank is one
process that reads its own time slice, so any layout is fed.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from bvc_tpu_torch.masks.tube import tube_mask
from bvc_tpu_torch.models.vit import layer_norm
from bvc_tpu_torch.parallel.analysis import with_comm_report
from bvc_tpu_torch.parallel.collectives import _summed, sum_over_ring
from bvc_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh,
                                         current_mesh)
from bvc_tpu_torch.training.optim import apply_schedules
from bvc_tpu_torch.training.probes import videomae_grad_metrics
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import (GradProbes, _sync_unless, eval_generator,
                                          global_rows, microbatches)
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig

RING = f"ring:{SEQ_AXIS}"  # the attention routing inside a ring


def _check_mesh(mesh: Mesh) -> None:
    if DATA_AXIS not in mesh.axis_names or SEQ_AXIS not in mesh.axis_names:
        raise ValueError(f"sequence-parallel steps need a ('{DATA_AXIS}', '{SEQ_AXIS}') "
                         f"mesh, got axes {mesh.axis_names}")


def local_sheets(cfg: ModelConfig, n_shards: int) -> int:
    """Temporal sheets (tubelets) a rank of a ring of ``n_shards`` holds."""
    t = cfg.num_time_steps
    if t % n_shards:
        raise ValueError(
            f"{t} temporal sheets do not split over {n_shards} seq shards "
            "(num_frames/tubelet_size must be divisible by the seq axis)")
    return t // n_shards


def time_slice(cfg: ModelConfig, mesh: Mesh | None = None) -> slice:
    """The frames of this rank's ``seq`` coordinate, ``[t0 * tubelet, t1 *
    tubelet)``: the part of every clip it loads and embeds."""
    mesh = mesh if mesh is not None else current_mesh()
    sheets = local_sheets(cfg, mesh.axis_size(SEQ_AXIS))
    t0 = mesh.coord(SEQ_AXIS) * sheets
    return slice(t0 * cfg.tubelet_size, (t0 + sheets) * cfg.tubelet_size)


def token_offset(cfg: ModelConfig, mesh: Mesh | None = None) -> int:
    """The position of this rank's first token in the clip's t-major order
    (its rows of the position tables start there)."""
    frames = time_slice(cfg, mesh)
    return frames.start // cfg.tubelet_size * cfg.tokens_per_frame


def mean_over_gradient_group(metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Scalar metrics averaged over the gradient group (``data`` x
    ``seq``: a rank's loss is its tokens' mean) in one all-reduce."""
    mesh = current_mesh()
    size = mesh.gradient_size()
    if size == 1:
        return metrics
    mean = _summed(torch.stack([v.detach().float() for v in metrics.values()]),
                   mesh.gradient_group()) / size
    return {k: m.to(v.dtype) for (k, v), m in zip(metrics.items(), mean)}


def _check_tube(mask_cfg: MaskConfig) -> None:
    if mask_cfg.sampler != "tube":
        raise ValueError(
            "sequence-parallel VideoMAE requires the tube sampler (its "
            "per-sheet visible count is what keeps shard shapes static); "
            f"got {mask_cfg.sampler!r}")


def _make_step(model_cfg: ModelConfig, mask_cfg: MaskConfig, grad_accum: int,
               grad_probes: GradProbes | None, mesh: Mesh, tp: bool):
    n_shards = mesh.axis_size(SEQ_AXIS)
    t_local = local_sheets(model_cfg, n_shards)
    hw = model_cfg.image_size // model_cfg.patch_size
    n_space = hw * hw
    n_masked_space = int(mask_cfg.mask_ratio * n_space)
    num_visible = (n_space - n_masked_space) * t_local
    grid = (model_cfg.num_time_steps, hw, hw)
    frames = time_slice(model_cfg, mesh)
    offset = token_offset(model_cfg, mesh)
    cols = slice(offset, offset + t_local * n_space)
    sampler = functools.partial(tube_mask, grid=grid, mask_ratio=mask_cfg.mask_ratio)

    def local(state: TrainState, video: torch.Tensor, mask: torch.Tensor | None,
              gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
        if tp and mesh.axis_size(MODEL_AXIS) > 1 and state.plan.params != MODEL_AXIS:
            raise ValueError("the seq x tp step needs the state laid out with its blocks' "
                             "heads over 'model' (TrainState.create(param_sharding='tp'))")
        want = frames.stop - frames.start
        if video.shape[1] != want:
            raise ValueError(f"video of {video.shape[1]} frames: this rank of the seq ring "
                             f"takes its time slice, frames [{frames.start}, {frames.stop})")
        video = video.to(state.device, non_blocking=True)
        if mask is None:
            mask = global_rows(functools.partial(sampler, gen), video.shape[0])
        return video, mask.to(state.device, non_blocking=True)[:, cols]

    def step(state: TrainState, video: torch.Tensor,
             mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """One step on this rank's block of the global batch, its time
        slice ``[b, T / S, H, W, C]``; ``mask`` (``[b, N]`` over the whole
        clip's tokens, as the unsharded step takes it) or drawn from the
        state's generator for the global batch."""
        if video.shape[0] % grad_accum:
            raise ValueError(f"grad_accum_steps ({grad_accum}) must divide the "
                             f"per-data-shard batch ({video.shape[0]})")
        video, mask = local(state, video, mask, state.generator)
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        loss = torch.zeros((), device=state.device)
        for j, (v, m) in enumerate(zip(microbatches(video, grad_accum),
                                       microbatches(mask, grad_accum))):
            with _sync_unless(state, j == grad_accum - 1):
                micro = state.forward(v, m, num_visible, RING, offset) / grad_accum
                micro.backward()
            loss += micro.detach()
        apply_schedules(opt, state.step)
        opt.step()
        state.step += 1
        metrics = {"loss": loss, **videomae_grad_metrics(model)}
        for name, fn in (grad_probes or {}).items():
            metrics[name] = fn(model)
        return mean_over_gradient_group(metrics)

    @torch.no_grad()
    def eval_step(state: TrainState, video: torch.Tensor, step_idx: int = 0,
                  mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        video, mask = local(state, video, mask, eval_generator(state, step_idx))
        return mean_over_gradient_group(
            {"loss": state.model(video, mask, num_visible, RING, offset)})

    step.eval_step = eval_step
    step.time_slice = frames
    return with_comm_report(step, "make_seq_tp_videomae_train_step" if tp
                            else "make_seq_videomae_train_step")


def make_seq_videomae_train_step(model_cfg: ModelConfig, mask_cfg: MaskConfig,
                                 param_sharding: str = "replicated", grad_accum: int = 1,
                                 grad_probes: GradProbes | None = None,
                                 mesh: Mesh | None = None
                                 ) -> Callable[..., dict[str, torch.Tensor]]:
    """The sequence-parallel VideoMAE step over a ``(data, seq)`` mesh
    (the process's when None): ``step(state, video, mask=None) ->
    metrics``, the contract of
    :func:`~bvc_tpu_torch.training.steps.make_videomae_train_step`, with
    ``video`` this rank's time slice of its data block (``step.time_slice``
    names its frames).  The state comes from ``TrainState.create(...,
    param_sharding=param_sharding)`` under the same mesh (DDP over the
    gradient group; ``zero1`` also partitions the optimizer over ``data``).

    Tube masks only.  ``grad_accum > 1`` runs that many microbatches of the
    rank's rows with one gradient reduction a step; it must divide them.
    Metrics: the unsharded step's, averaged over the gradient group.
    ``step.eval_step(state, video, step_idx=0, mask=None)``."""
    mesh = mesh if mesh is not None else current_mesh()
    _check_mesh(mesh)
    _check_tube(mask_cfg)
    if param_sharding not in ("replicated", "zero1"):
        raise ValueError(
            "this step composes with 'replicated' or 'zero1' param "
            f"sharding (got {param_sharding!r}). FSDP stays rejected: it "
            "would re-gather the whole stack per layer inside the ring. "
            "Tensor parallelism IS available — add a 'model' mesh axis "
            "and use make_seq_tp_videomae_train_step (heads-sharded "
            "Megatron TP composed with the ring; --mesh "
            "data=..,seq=..,model=.. on the CLI)")
    return _make_step(model_cfg, mask_cfg, grad_accum, grad_probes, mesh, tp=False)


def make_seq_tp_videomae_train_step(model_cfg: ModelConfig, mask_cfg: MaskConfig,
                                    grad_probes: GradProbes | None = None,
                                    grad_accum: int = 1, mesh: Mesh | None = None
                                    ) -> Callable[..., dict[str, torch.Tensor]]:
    """The sequence-parallel x tensor-parallel VideoMAE step over a
    ``(data, seq, model)`` mesh: the contract of
    :func:`make_seq_videomae_train_step`, on a state made with
    ``param_sharding='tp'`` (each block holds its ``model`` rank's heads
    and MLP columns; the ring runs on those heads)."""
    mesh = mesh if mesh is not None else current_mesh()
    _check_mesh(mesh)
    if MODEL_AXIS not in mesh.axis_names:
        raise ValueError(
            f"the seq x tp step needs a '{MODEL_AXIS}' mesh axis "
            f"(got {mesh.axis_names}); use --mesh data=..,seq=..,model=..")
    tp = mesh.axis_size(MODEL_AXIS)
    for what, heads in (("num_heads", model_cfg.num_heads),
                        ("decoder_num_heads", model_cfg.decoder_num_heads)):
        if heads % tp:
            raise ValueError(f"tensor parallelism shards whole heads: {what}={heads} "
                             f"does not divide over model={tp}")
    _check_tube(mask_cfg)
    return _make_step(model_cfg, mask_cfg, grad_accum, grad_probes, mesh, tp=True)


def seq_embed(encoder: torch.nn.Module, video: torch.Tensor,
              mesh: Mesh | None = None) -> torch.Tensor:
    """The embedding ``[B, D]`` f32 of whole clips from this rank's time
    slice ``video`` of them (every rank of the ring calls it on its slice
    of the same clips): VideoMAE's ``LayerNorm(mean(tokens))`` with unit
    affine (the encoder's tokens summed in f32, the sums added over the
    ring, divided by the clip's token count, then the parameterless norm),
    or V-JEPA's mean of the final-normed tokens, summed the same way."""
    from bvc_tpu_torch.models.jepa import JEPAEncoder

    mesh = mesh if mesh is not None else current_mesh()
    cfg = encoder.cfg
    local_sheets(cfg, mesh.axis_size(SEQ_AXIS))
    offset = token_offset(cfg, mesh)
    if isinstance(encoder, JEPAEncoder):
        x = encoder(video, attn_impl=RING, token_offset=offset)
    else:
        x = encoder.forward_features(video, RING, offset)
    pooled = sum_over_ring(x.float().sum(dim=1)) / cfg.seq_len
    return pooled if isinstance(encoder, JEPAEncoder) else layer_norm(pooled, None, None, 1e-6)
