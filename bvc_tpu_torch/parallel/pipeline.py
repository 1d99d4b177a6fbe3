"""Pipeline-parallel VideoMAE: GPipe microbatching over a ``pipe`` mesh
axis (counterpart of :mod:`bvc_tpu.parallel.pipeline`).

A ``--mesh data=D,pipe=P`` run places contiguous chunks of both block
stacks on successive ranks: stage ``s`` (the rank's ``pipe`` coordinate)
holds encoder layers ``[s L/P, (s+1) L/P)`` and decoder layers ``[s Ld/P,
(s+1) Ld/P)``, under their whole-model names (``encoder.blocks.layers.7``
on stage 1 of 2 at ViT-B), so checkpoints, the gradient probes and the
optimizer's state read the same names as one process.  The edge
parameters (patch embedding, ``enc_to_dec``, the mask token, the decoder
norm and head) stay whole on every stage, as ``P()`` leaves them in JAX;
the edge work runs on one stage: patchify, the visible gather, the embed
and the encoder-to-decoder bridge on stage 0, the decoder norm, the head
and the norm-pix loss on stage P-1.  A stage's optimizer holds its own
parameters, so a rank's parameter and optimizer bytes are about 1/P of
the stacks' plus the edge.

The schedule is GPipe, written by hand over :func:`~bvc_tpu_torch.
parallel.collectives.hop` (one activation to the next stage and one from
the previous in a single paired exchange) with detached stage boundaries:

- forward, one stack at a time: at tick ``t`` stage ``s`` runs microbatch
  ``t - s`` through its layers (``M + P - 1`` ticks, no work on the
  warm-up ticks, where JAX's scan computes on junk) and keeps each
  microbatch's input (a leaf that takes a gradient) and output;
- one relay hop takes the encoder's outputs from stage P-1 to stage 0,
  which bridges them into the decoder's stack;
- backward in reverse order, again one stack at a time: stage ``s`` runs
  ``torch.autograd.backward(out, grad_out)`` for its microbatches from the
  last to the first and hands each input's gradient to the stage before;
  the relay's gradient goes back from stage 0 to stage P-1 between the
  stacks.

Every collective stays out of the autograd engine, and every rank posts
its sends in a fixed order.  The layers run without remat or drop-path, as
JAX's ``_pipeline_stack`` calls ``run_blocks``.

Exactness, as JAX's module argues: microbatch j meets exactly the layers
it would on one card; both samplers (``tube``, ``random``) fix the masked
count of every sample, so the mean of the microbatch means is the batch
mean; the gradients are summed over the microbatches.  The step equals
one process's at the global batch.

Gradients (JAX's ``_reduce_grads``), as explicit bucketed all-reduces (no
DDP: its forward hooks do not fit M forwards through part of a model): the
edge parameters' gradients summed over the ``pipe`` group (only their
resident stage holds a nonzero one), then every gradient averaged over the
``data`` group (the ranks that share the stage).  Metrics: the loss summed
over ``pipe`` (only stage P-1 has it) and averaged over ``data``; the
gradient norms as sums of squares over the stages, each edge parameter
counted once; the same on every rank.
"""

from __future__ import annotations

import functools
import re
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from bvc_tpu_torch.parallel.analysis import with_comm_report
from bvc_tpu_torch.parallel.collectives import hop
from bvc_tpu_torch.parallel.mesh import DATA_AXIS, PIPE_AXIS, Mesh, current_mesh, make_mesh
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig

BUCKET_BYTES = 25 * 2**20  # the gradient all-reduces' buckets (DDP's default size)
_STACK = re.compile(r"^(encoder\.blocks\.layers|decoder\.layers)\.(\d+)\.")


def make_pipe_mesh(data: int, pipe: int) -> Mesh:
    """The ``(data, pipe)`` mesh over the process group, ``pipe`` fastest:
    neighbouring stages are neighbouring ranks."""
    return make_mesh({DATA_AXIS: data, PIPE_AXIS: pipe})


def _check_mesh(mesh: Mesh) -> None:
    if DATA_AXIS not in mesh.axis_names or PIPE_AXIS not in mesh.axis_names:
        raise ValueError(f"pipeline-parallel steps need a ('{DATA_AXIS}', '{PIPE_AXIS}') "
                         f"mesh, got axes {mesh.axis_names}")


def _stage_depths(cfg: ModelConfig, n_stages: int) -> tuple[int, int]:
    if cfg.depth % n_stages or cfg.decoder_depth % n_stages:
        raise ValueError(
            f"encoder depth {cfg.depth} and decoder depth "
            f"{cfg.decoder_depth} must both divide over {n_stages} pipeline "
            "stages (each stage holds an equal contiguous layer chunk)")
    return cfg.depth // n_stages, cfg.decoder_depth // n_stages


def _stack_layer(name: str) -> tuple[str, int] | None:
    """``(stack, layer)`` of a block parameter's name, None for an edge one."""
    m = _STACK.match(name)
    return (m.group(1), int(m.group(2))) if m else None


def pipe_param_specs(names, cfg: ModelConfig, stage: int, n_stages: int) -> list[str]:
    """The names (of ``names``, a whole model's) that stage ``stage`` of
    ``n_stages`` holds: its chunk of each block stack and every edge
    parameter (JAX: ``P('pipe')`` on the stacks' depth axis, ``P()`` on the
    rest)."""
    enc, dec = _stage_depths(cfg, n_stages)
    per = {"encoder.blocks.layers": enc, "decoder.layers": dec}
    out = []
    for name in names:
        where = _stack_layer(name)
        if where is None or where[1] // per[where[0]] == stage:
            out.append(name)
    return out


class StageLayers(nn.Module):
    """Layers ``[lo, hi)`` of a stack, registered under their whole-stack
    indices (``layers.6`` stays ``layers.6``)."""

    def __init__(self, layers: nn.ModuleList, lo: int, hi: int):
        super().__init__()
        for i in range(lo, hi):
            self.add_module(str(i), layers[i])

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)


@dataclass
class PipeStage:
    """A rank's stage: its coordinate among ``n_stages``, the ``pipe``
    group (None: the world, or no group), the whole model's state-dict keys
    and optimizer groups (``(decay, names)`` in index order), and the names
    of the stage's own parameters in its optimizer's index order, so that
    checkpoints hold whole tensors in one process's layout."""

    stage: int
    n_stages: int
    group: object
    names: list[str]
    groups: list[tuple[bool, list[str]]]
    own: list[str]

    def _gather(self, local: dict) -> dict:
        """Every stage's ``local`` dict merged (a collective over ``pipe``)."""
        if self.n_stages == 1:
            return dict(local)
        parts: list = [None] * self.n_stages
        dist.all_gather_object(parts, local, group=self.group)
        merged: dict = {}
        for part in parts:
            merged.update(part)
        return merged

    def whole_state_dict(self, model: nn.Module) -> dict[str, torch.Tensor]:
        """The whole model's state dict, on the CPU, in one process's key
        order: every stage's blocks gathered over ``pipe``."""
        merged = self._gather({k: v.detach().cpu() for k, v in model.state_dict().items()})
        return {k: merged[k] for k in self.names}

    def load_whole_state_dict(self, model: nn.Module, sd: dict[str, torch.Tensor]) -> None:
        """Load whole tensors (a checkpoint's) into the stage's model: its
        own keys."""
        model.load_state_dict({k: sd[k] for k in model.state_dict()})

    def _index(self) -> dict[str, int]:
        order = [n for _, names in self.groups for n in names]
        return {n: i for i, n in enumerate(order)}

    def whole_optimizer_state(self, optimizer: torch.optim.Optimizer) -> dict:
        """``optimizer.state_dict()`` (the stage's optimizer's) of the whole
        model, on the CPU: every stage's per-parameter state gathered over
        ``pipe`` and indexed as one process's optimizer indexes it."""
        sd = optimizer.state_dict()
        local = {self.own[i]: {k: v.detach().cpu() if torch.is_tensor(v) else v
                               for k, v in st.items()}
                 for i, st in sd["state"].items()}
        merged, index = self._gather(local), self._index()
        hyper = {g["decay"]: {k: v for k, v in g.items() if k != "params"}
                 for g in sd["param_groups"]}
        return {"state": {index[n]: merged[n] for n in sorted(merged, key=index.get)},
                "param_groups": [{**hyper[decay], "params": [index[n] for n in group]}
                                 for decay, group in self.groups]}

    def stage_optimizer_state(self, saved: dict) -> dict:
        """A whole optimizer state dict (one process's indices) cut to this
        stage's parameters, indexed as its optimizer indexes them."""
        index = self._index()
        state = {int(k): v for k, v in saved["state"].items()}
        return {"state": {i: state[index[n]] for i, n in enumerate(self.own)
                          if index[n] in state},
                "param_groups": saved["param_groups"]}


def lay_out_stage(model: nn.Module, optim_cfg: OptimConfig, mesh: Mesh | None = None
                  ) -> PipeStage:
    """Cut ``model`` (a :class:`~bvc_tpu_torch.models.videomae.
    VideoMAEPretrain`) to this rank's stage of ``mesh`` (the process's when
    None): its encoder and decoder keep their chunks of layers, under their
    whole-stack names, and every edge parameter.  Returns the stage, which
    the model also carries as ``model.pipe_stage``."""
    from bvc_tpu_torch.training.optim import grouped_names

    mesh = mesh if mesh is not None else current_mesh()
    _check_mesh(mesh)
    if not hasattr(model, "decoder") or not hasattr(getattr(model, "encoder", None), "blocks"):
        raise ValueError("a 'pipe' mesh lays out VideoMAE's pretraining model only "
                         f"(got {type(model).__name__})")
    n_stages, s = mesh.axis_size(PIPE_AXIS), mesh.coord(PIPE_AXIS)
    enc, dec = _stage_depths(model.cfg, n_stages)
    names, groups = list(model.state_dict()), grouped_names(optim_cfg, model.named_parameters())
    model.encoder.blocks.layers = StageLayers(model.encoder.blocks.layers, s * enc,
                                              (s + 1) * enc)
    model.decoder.layers = StageLayers(model.decoder.layers, s * dec, (s + 1) * dec)
    own = [name for _, group in grouped_names(optim_cfg, model.named_parameters())
           for name in group]
    model.pipe_stage = PipeStage(s, n_stages, mesh.group(PIPE_AXIS), names, groups, own)
    return model.pipe_stage


def pipe_state_shardings(state) -> PipeStage:
    """The stage layout a pipe state holds (``TrainState.create`` on a
    mesh with ``pipe``): which stage, and which parameters it keeps
    (:func:`pipe_param_specs`)."""
    stage = getattr(state.model, "pipe_stage", None)
    if stage is None:
        raise ValueError("the state is not laid out over a 'pipe' mesh "
                         "(TrainState.create under make_pipe_mesh)")
    return stage


def _all_reduce_buckets(tensors: list[torch.Tensor], group) -> None:
    """Sum each tensor over ``group`` in place, in flat buckets of about
    :data:`BUCKET_BYTES`."""
    bucket: list[torch.Tensor] = []
    size = 0

    def flush():
        if not bucket:
            return
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))
        bucket.clear()

    for t in tensors:
        if bucket and (size + t.numel() * t.element_size() > BUCKET_BYTES
                       or t.dtype != bucket[0].dtype):
            flush()
            size = 0
        bucket.append(t)
        size += t.numel() * t.element_size()
    flush()


def make_pipe_videomae_train_step(model_cfg: ModelConfig, mask_cfg: MaskConfig,
                                  num_microbatches: int = 4,
                                  grad_probes: dict[str, Callable] | None = None,
                                  grad_accum: int = 1, mesh: Mesh | None = None
                                  ) -> Callable[..., dict[str, torch.Tensor]]:
    """The pipeline-parallel VideoMAE step over a ``(data, pipe)`` mesh (the
    process's when None): ``step(state, video, mask=None) -> metrics``, the
    contract of :func:`~bvc_tpu_torch.training.steps.make_videomae_train_step`,
    on a state made by ``TrainState.create`` under the same mesh (which
    lays out the stage).  ``video`` is the rank's data block of the global
    batch (every stage of a data row takes the same one); a given ``mask``
    (``[b, N]``) is used as it is, else every stage draws the global
    batch's from the state's generator and keeps its data block's rows, so
    the stages agree and their generators stay in step.

    ``num_microbatches`` (M) microbatches go through the stages per pass;
    ``grad_accum > 1`` runs that many passes (one a strided chunk of the
    rank's rows) before the one update.  M must divide the chunk.
    ``grad_probes`` (name -> fn(model)) read the stage's model after the
    reduction, where every edge parameter's gradient is whole (the
    VideoMAE grad-stats table reads only those).  Metrics: the
    one-process step's, the same on every rank.
    ``step.eval_step(state, video, step_idx=0, mask=None)`` returns
    ``{"loss": ...}``."""
    from bvc_tpu_torch.masks.tube import mask_partition
    from bvc_tpu_torch.models.videomae import _DTYPES, normalize_on_device, patch_targets
    from bvc_tpu_torch.training.optim import apply_schedules
    from bvc_tpu_torch.training.probes import videomae_grad_sumsqs
    from bvc_tpu_torch.training.steps import (eval_generator, global_rows, mask_sampler,
                                              mean_over_ranks, microbatches)

    mesh = mesh if mesh is not None else current_mesh()
    _check_mesh(mesh)
    if mask_cfg.sampler not in ("tube", "random"):
        raise ValueError(
            "pipeline-parallel VideoMAE supports the 'tube' and 'random' "
            "samplers (fixed per-sample visible count); got "
            f"{mask_cfg.sampler!r}")
    P, s = mesh.axis_size(PIPE_AXIS), mesh.coord(PIPE_AXIS)
    _stage_depths(model_cfg, P)
    group, data_group = mesh.group(PIPE_AXIS), mesh.group(DATA_AXIS)
    D = mesh.axis_size(DATA_AXIS)
    first, last = s == 0, s == P - 1
    sampler, num_visible = mask_sampler(model_cfg, mask_cfg)
    n_masked = model_cfg.seq_len - num_visible
    dtype = _DTYPES[model_cfg.dtype]
    M = num_microbatches
    ready: list[bool] = []

    def hop_to(send, to, recv_shape, source, device):
        if P == 1:
            return None
        return hop(send, to, None if recv_shape is None else (recv_shape, dtype), source,
                   group, device)

    def forward_stack(layers, inputs: Callable[[int], torch.Tensor], shape, device,
                      train: bool) -> tuple[list, list]:
        """GPipe forward of one stack: this stage's inputs and outputs, by
        microbatch.  Stage 0 takes microbatch j's input from ``inputs(j)``,
        the others from the stage before; ``shape`` is a microbatch's."""
        ins, outs, held = [None] * M, [None] * M, None
        for t in range(M + P - 1):
            j, out = t - s, None
            if 0 <= j < M:
                x = inputs(j) if first else held.requires_grad_(train)
                for layer in layers:
                    x = layer(x)
                ins[j] = None if first else held
                outs[j] = out = x
            nxt = t + 1 - s
            held = hop_to(None if out is None or last else out.detach(), s + 1,
                          shape if not first and 0 <= nxt < M else None, s - 1, device)
        return ins, outs

    def backward_stack(ins, outs, grad_last: Callable[[int], None], shape, device) -> None:
        """GPipe backward of one stack, microbatches in reverse order: stage
        P-1 starts each from ``grad_last(j)``, the others from the gradient
        the stage after sends; every stage but 0 sends its input's
        gradient back."""
        held = None
        for t in range(M + P - 1):
            j, gin = M - 1 - (t - (P - 1 - s)), None
            if 0 <= j < M:
                if last:
                    grad_last(j)
                else:
                    torch.autograd.backward(outs[j], held)
                outs[j] = None
                if not first:
                    gin = ins[j].grad
                    ins[j] = None
            nxt = M - 1 - (t + 1 - (P - 1 - s))
            held = hop_to(gin, s - 1, shape if not last and 0 <= nxt < M else None, s + 1,
                          device)

    def relay(x: torch.Tensor | None, to_first: bool, shape, device) -> torch.Tensor | None:
        """One hop between stage P-1 and stage 0: the encoder's outputs
        forward (``to_first``), their gradient backward."""
        if P == 1:
            return x
        src, dst = (P - 1, 0) if to_first else (0, P - 1)
        return hop_to(x if s == src else None, dst, shape if s == dst else None, src, device)

    def one_pass(state, video, mask, scale: float, train: bool) -> torch.Tensor:
        """One pipeline pass over the rows ``video``/``mask``: the stage's
        share of the loss (the mean of the microbatches' mean losses on
        stage P-1, 0 elsewhere) times ``scale``; with ``train`` the
        gradients, times ``scale``, added into the stage's parameters."""
        model, device = state.model, state.device
        b = video.shape[0]
        if b % M:
            raise ValueError(f"num_microbatches ({M}) must divide the per-data-shard "
                             f"batch ({b})")
        mb = b // M
        visible_idx, masked_idx = mask_partition(mask, num_visible)
        rows = [slice(j * mb, (j + 1) * mb) for j in range(M)]
        enc_shape = (mb, num_visible, model_cfg.hidden_size)
        dec_shape = (mb, model_cfg.seq_len, model_cfg.decoder_hidden_size)
        loss = torch.zeros((), device=device)

        def embed(j):
            return model.encoder.embed_visible(video[rows[j]], visible_idx[rows[j]])

        ins, outs = forward_stack(model.encoder.blocks.layers, embed, enc_shape, device, train)
        sent = torch.cat([o.detach() for o in outs]) if last and P > 1 else None
        got = relay(sent, True, (b, *enc_shape[1:]), device)
        encoded = None
        if first:  # leaves: the decoder's backward stops at them
            whole = got if P > 1 else torch.cat([o.detach() for o in outs])
            encoded = [whole[r].detach().requires_grad_(train) for r in rows]

        def bridge(j):
            return model.bridge(encoded[j], visible_idx[rows[j]], masked_idx[rows[j]])

        dins, douts = forward_stack(model.decoder.layers, bridge, dec_shape, device, train)
        losses = [None] * M
        if last:
            for j in range(M):
                preds = model.predict(douts[j], n_masked)
                targets = patch_targets(video[rows[j]], model_cfg, masked_idx[rows[j]])
                losses[j] = (preds.float() - targets).square().mean() * (scale / M)
                loss = loss + losses[j].detach()
        if not train:
            return loss

        backward_stack(dins, douts, lambda j: losses[j].backward(), dec_shape, device)
        grads = (torch.cat([e.grad for e in encoded]) if first and P > 1 else None)
        back = relay(grads, False, (b, *enc_shape[1:]), device)
        if last:
            enc_grads = back if P > 1 else torch.cat([e.grad for e in encoded])

            def grad_last(j):
                torch.autograd.backward(outs[j], enc_grads[rows[j]])
        else:
            grad_last = None
        backward_stack(ins, outs, grad_last, enc_shape, device)
        return loss

    def reduce_grads(model) -> None:
        params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        for _, p in params:
            if p.grad is None:  # an edge parameter off its stage
                p.grad = torch.zeros_like(p)
        if P > 1:
            # an edge parameter's gradient is its resident stage's alone
            _all_reduce_buckets([p.grad for n, p in params if _stack_layer(n) is None], group)
        if D > 1:
            grads = [p.grad for _, p in params]
            _all_reduce_buckets(grads, data_group)
            torch._foreach_div_(grads, D)

    def summed_over_stages(values: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        if P == 1:
            return values
        flat = torch.stack([v.float() for v in values.values()])
        dist.all_reduce(flat, group=group)
        return dict(zip(values, flat))

    def local(state, video, mask, gen):
        stage = pipe_state_shardings(state)
        if stage.n_stages != P or stage.stage != s:
            raise ValueError(f"the state holds stage {stage.stage} of {stage.n_stages}, "
                             f"the mesh this step was made for stage {s} of {P}")
        if P > 1 and not ready:  # a first collective in the group before any send
            dist.all_reduce(torch.zeros(1, device=state.device), group=group)
            ready.append(True)
        video = video.to(state.device, non_blocking=True)
        if mask is None:
            mask = global_rows(functools.partial(sampler, gen), video.shape[0])
        mask = mask.to(state.device, non_blocking=True)
        if first or last:  # the middle stages never read the pixels
            video = normalize_on_device(video)
        return video, mask

    def step(state, video: torch.Tensor, mask: torch.Tensor | None = None
             ) -> dict[str, torch.Tensor]:
        """One step on this rank's data block ``[b, T, H, W, C]``."""
        if video.shape[0] % grad_accum:
            raise ValueError(f"grad_accum_steps ({grad_accum}) must divide the "
                             f"per-data-shard batch ({video.shape[0]})")
        video, mask = local(state, video, mask, state.generator)
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        loss = torch.zeros((), device=state.device)
        for v, m in zip(microbatches(video, grad_accum), microbatches(mask, grad_accum)):
            loss += one_pass(state, v, m, 1.0 / grad_accum, train=True)
        reduce_grads(model)
        # each edge parameter counted once: on stage 0
        sums = videomae_grad_sumsqs(model, lambda n, p: first or _stack_layer(n) is not None)
        totals = summed_over_stages({"loss": loss, **sums})
        apply_schedules(opt, state.step)
        opt.step()
        state.step += 1
        metrics = {"loss": totals.pop("loss")}
        metrics.update({k: v.sqrt() for k, v in totals.items()})
        for name, fn in (grad_probes or {}).items():
            metrics[name] = fn(model)
        return mean_over_ranks(metrics)

    @torch.no_grad()
    def eval_step(state, video: torch.Tensor, step_idx: int = 0,
                  mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        video, mask = local(state, video, mask, eval_generator(state, step_idx))
        loss = one_pass(state, video, mask, 1.0, train=False)
        return mean_over_ranks(summed_over_stages({"loss": loss}))

    step.eval_step = eval_step
    return with_comm_report(step)
