"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda``.  With no device named and no GPU present this raises rather
    than carrying on on the CPU; pass ``device='cpu'`` to run there."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run bvc_tpu_torch on the CPU")
    return torch.device("cuda")
