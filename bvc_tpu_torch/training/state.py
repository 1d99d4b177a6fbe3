"""Train state (counterpart of :class:`bvc_tpu.training.state.TrainState`).

The JAX state is an immutable pytree threaded through a jitted step; here
it is one object that the step updates in place: the count of steps taken,
the model, its optimizer and the ``torch.Generator`` the masks are drawn
from, all on one device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from bvc_tpu_torch.training.optim import make_optimizer
from bvc_tpu_torch.utils.config import OptimConfig
from bvc_tpu_torch.utils.device import resolve_device


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return self.generator.device

    @staticmethod
    def create(model: torch.nn.Module, optim_cfg: OptimConfig, seed: int = 1,
               device: str | torch.device | None = None,
               steps: tuple[int, int] | None = None) -> "TrainState":
        """Move ``model`` to ``device`` (``cuda`` when None; raises when
        there is none, see :func:`resolve_device`), build its optimizer
        (``steps`` as :func:`make_optimizer` takes them) and a mask
        generator seeded with ``seed`` on the same device."""
        device = resolve_device(device)
        model = model.to(device)
        return TrainState(step=0, model=model,
                          optimizer=make_optimizer(optim_cfg, model.named_parameters(), steps),
                          generator=torch.Generator(device=device).manual_seed(seed))
