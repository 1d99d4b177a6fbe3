"""Train state (counterpart of :class:`bvc_tpu.training.state.TrainState`
and of :func:`bvc_tpu.training.steps.place_state`).

The JAX state is an immutable pytree threaded through a jitted step; here
it is one object that the step updates in place: the count of steps taken,
the model, its optimizer, the ``torch.Generator`` the masks are drawn from
and, for JEPA, the EMA target encoder (``target``, no gradients), all on
one device.  Under a process group the parameters lie over the ranks by the
state's :class:`~bvc_tpu_torch.parallel.sharding.ShardingPlan` (the
``--param_sharding`` mode on the process's mesh):

- ``replicated``, ``zero1`` and ``tp``: the state also holds the model in
  ``DistributedDataParallel`` over the ``data`` ranks (``ddp``), which the
  steps call, so that the gradients are averaged over them (on a mesh with
  ``seq``, over the ``data`` x ``seq`` ranks of the gradient group:
  :mod:`bvc_tpu_torch.parallel.seqpar`); ``model`` stays
  the plain module (under ``tp`` its blocks hold the rank's heads).  Under
  ``zero1`` the optimizer is a ``ZeroRedundancyOptimizer``;
- ``fsdp``: ``model`` itself is the ``fully_shard``-ed module, and the
  steps call it; there is no ``ddp``;
- beside a ``model`` axis, ``zero1`` and ``fsdp`` keep replicas over it:
  the DDP of ``zero1`` spans ``data`` x ``model``, and FSDP2 runs on a
  ``(model, data)`` device mesh;
- on a mesh with ``pipe`` (:mod:`bvc_tpu_torch.parallel.pipeline`):
  ``model`` keeps the rank's stage of the block stacks and every edge
  parameter (``model.pipe_stage``), the optimizer holds those, and there
  is no ``ddp``: the pipeline step reduces the gradients itself.

The target encoder takes the online encoder's layout (the JAX package
shards ``target_params`` by the same mode), so the EMA update runs on
matching local parts (:meth:`TrainState.ema_update`).  Checkpoints go
through :meth:`TrainState.model_state_dict`,
:meth:`~TrainState.target_state_dict` and their loaders, which hold whole
tensors whatever the layout.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from bvc_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh, current_mesh
from bvc_tpu_torch.parallel.sharding import (ShardingPlan, full_state_dict,
                                             load_full_state_dict, local_tensor,
                                             param_shardings, resharded, shard_fully,
                                             shard_heads, wrap_data_parallel)
from bvc_tpu_torch.training.optim import make_optimizer
from bvc_tpu_torch.utils.config import OptimConfig
from bvc_tpu_torch.utils.device import resolve_device


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    target: torch.nn.Module | None = None
    ddp: torch.nn.Module | None = None
    plan: ShardingPlan = field(default_factory=lambda: ShardingPlan("replicated"))

    @property
    def device(self) -> torch.device:
        return self.generator.device

    @property
    def forward(self) -> torch.nn.Module:
        """The module a step calls: ``ddp`` when there is one, else
        ``model`` (under ``fsdp`` the sharded module itself)."""
        return self.ddp if self.ddp is not None else self.model

    @property
    def fsdp(self) -> bool:
        """True when ``model`` is sharded by FSDP2 (``fsdp`` under a
        process group)."""
        return self.plan.params == DATA_AXIS and dist.is_initialized()

    @staticmethod
    def create(model: torch.nn.Module, optim_cfg: OptimConfig, seed: int = 1,
               device: str | torch.device | None = None,
               steps: tuple[int, int] | None = None,
               target: torch.nn.Module | None = None,
               param_sharding: str = "replicated", mesh: Mesh | None = None
               ) -> "TrainState":
        """Move ``model`` to ``device`` (``cuda`` when None; raises when
        there is none, see :func:`resolve_device`), lay it out by
        ``param_sharding`` over the process's mesh, build its optimizer
        (``steps`` as :func:`make_optimizer` takes them) and a mask
        generator seeded with ``seed`` on the same device.  ``target`` (the
        JEPA EMA encoder, e.g. a deep copy of ``model.encoder``) moves to
        the device with its gradients off, takes the model's layout and
        stays outside DDP (it takes no gradient; every rank moves its part
        by the same averaged update).

        Under an initialised process group: ``replicated``, ``zero1`` and
        ``tp`` put the model into ``DistributedDataParallel`` over the
        gradient group (the ``data`` ranks; ``data`` x ``seq`` on a mesh
        with ``seq``; :func:`wrap_data_parallel`), which broadcasts the
        first data rank's weights; ``tp`` splits the blocks over the
        ``model`` ranks first (:func:`shard_heads`), ``fsdp`` shards the
        model over the ``data`` ranks instead (:func:`shard_fully`).  Every
        rank builds the same weights from the same seed before the split.
        Without a group every mode is the one-process layout.  ``mesh`` is
        the process's (:func:`current_mesh`) when None; a trainer passes
        the one it made, which in one process may carry a ``pipe`` axis of
        one stage."""
        device = resolve_device(device)
        mesh = mesh if mesh is not None else current_mesh()
        plan = param_shardings(param_sharding, mesh)
        grouped = dist.is_initialized()
        stage = None
        if plan.params == PIPE_AXIS:  # the stage's blocks only, before they reach the device
            from bvc_tpu_torch.parallel.pipeline import lay_out_stage

            stage = lay_out_stage(model, optim_cfg, mesh)
        model = model.to(device)
        if target is not None:
            target = target.to(device).requires_grad_(False)
        modules = [m for m in (model, target) if m is not None]
        if grouped and plan.params == MODEL_AXIS:
            for m in modules:
                shard_heads(m, mesh)
        if grouped and plan.params == DATA_AXIS:
            model, target = (shard_fully(m, device, mesh) if m is not None else None
                             for m in (model, target))
        zero_group = None
        if grouped and plan.optimizer == DATA_AXIS:
            zero_group = mesh.group(DATA_AXIS) or dist.group.WORLD
        ddp = None
        if grouped and plan.params not in (DATA_AXIS, PIPE_AXIS):
            # replicas over model: the gradients averaged over data x model (the world)
            ddp = wrap_data_parallel(model, device, None if plan.replicas else
                                     mesh.gradient_group())
        optimizer = make_optimizer(optim_cfg, model.named_parameters(), steps, zero_group)
        optimizer.pipe_stage = stage  # checkpoints gather a stage's state over pipe
        return TrainState(step=0, model=model, optimizer=optimizer,
                          generator=torch.Generator(device=device).manual_seed(seed),
                          target=target, ddp=ddp, plan=plan)

    @torch.no_grad()
    def ema_update(self, m: float) -> None:
        """``target = m * target + (1 - m) * model.encoder``, each rank on
        its parts (the two share a layout)."""
        target = [local_tensor(p) for p in resharded(self.target).parameters()]
        online = [local_tensor(p) for p in resharded(self.model).encoder.parameters()]
        torch._foreach_mul_(target, m)
        torch._foreach_add_(target, online, alpha=1.0 - m)

    def model_state_dict(self) -> dict[str, torch.Tensor]:
        """The model's state dict with whole tensors, whatever the layout
        (a collective under ``fsdp``, ``tp`` and on a pipe mesh, where every
        stage's blocks are gathered to the CPU: every rank calls it)."""
        stage = getattr(self.model, "pipe_stage", None)
        if stage is not None:
            return stage.whole_state_dict(self.model)
        return full_state_dict(self.model)

    def target_state_dict(self) -> dict[str, torch.Tensor]:
        """The target encoder's, as :meth:`model_state_dict`."""
        return full_state_dict(self.target)

    def load_model_state_dict(self, sd: dict[str, torch.Tensor]) -> None:
        """Load whole tensors (a checkpoint's) into the model, each rank
        taking its parts (a pipeline stage its blocks and the edge)."""
        stage = getattr(self.model, "pipe_stage", None)
        if stage is not None:
            stage.load_whole_state_dict(self.model, sd)
        else:
            load_full_state_dict(self.model, sd)

    def load_target_state_dict(self, sd: dict[str, torch.Tensor]) -> None:
        load_full_state_dict(self.target, sd)
