"""Train state (counterpart of :class:`bvc_tpu.training.state.TrainState`).

The JAX state is an immutable pytree threaded through a jitted step; here
it is one object that the step updates in place: the count of steps taken,
the model, its optimizer, the ``torch.Generator`` the masks are drawn from
and, for JEPA, the EMA target encoder (``target``, no gradients), all on
one device.  Under a process group the state also holds the model in
``DistributedDataParallel`` (``ddp``), which the steps call, so that the
gradients are averaged over the ranks; ``model`` stays the plain module,
from which checkpoints are written.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from bvc_tpu_torch.parallel.sharding import wrap_data_parallel
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

    @property
    def device(self) -> torch.device:
        return self.generator.device

    @property
    def forward(self) -> torch.nn.Module:
        """The module a step calls: ``ddp`` under a process group, else
        ``model``."""
        return self.ddp if self.ddp is not None else self.model

    @staticmethod
    def create(model: torch.nn.Module, optim_cfg: OptimConfig, seed: int = 1,
               device: str | torch.device | None = None,
               steps: tuple[int, int] | None = None,
               target: torch.nn.Module | None = None) -> "TrainState":
        """Move ``model`` to ``device`` (``cuda`` when None; raises when
        there is none, see :func:`resolve_device`), build its optimizer
        (``steps`` as :func:`make_optimizer` takes them) and a mask
        generator seeded with ``seed`` on the same device.  ``target`` (the
        JEPA EMA encoder, e.g. a deep copy of ``model.encoder``) moves to
        the device with its gradients off and stays outside DDP (it takes no
        gradient; every rank moves it by the same averaged update).  Under
        an initialised process group the model goes into
        ``DistributedDataParallel`` (:func:`wrap_data_parallel`), which
        broadcasts rank 0's weights."""
        device = resolve_device(device)
        model = model.to(device)
        if target is not None:
            target = target.to(device).requires_grad_(False)
        return TrainState(step=0, model=model,
                          optimizer=make_optimizer(optim_cfg, model.named_parameters(), steps),
                          generator=torch.Generator(device=device).manual_seed(seed),
                          target=target,
                          ddp=wrap_data_parallel(model, device) if dist.is_initialized()
                          else None)
