"""Device choice for the port's entry points, and timing on the card."""

from __future__ import annotations

import torch
import torch.distributed as dist


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda``.  Under an initialised process group a CUDA device without an
    index is the rank's own, ``cuda:LOCAL_RANK`` (the current device, which
    :func:`bvc_tpu_torch.parallel.distributed_init` set).  With no device
    named and no GPU present this raises rather than carrying on on the
    CPU; pass ``device='cpu'`` to run there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run bvc_tpu_torch on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls after ``warmup``
    untimed ones, by CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
