"""How batches and parameters map onto the ranks (counterpart of
:mod:`bvc_tpu.parallel.sharding`).

The JAX package gives parameters a ``NamedSharding`` and shards the batch
over ``data``; XLA emits the gradient all-reduce.  The port does what the
reference does: every rank holds the whole model inside
``DistributedDataParallel`` and its contiguous block of each global batch,
and DDP's bucket hooks all-reduce (average) the gradients during the
backward.  The ``zero1``, ``fsdp`` and ``tp`` parameter layouts come with
slice 7b of the port.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from bvc_tpu_torch.parallel.mesh import rank, world_size

PARAM_SHARDINGS = ("replicated", "zero1", "fsdp", "tp")


def param_shardings(mode: str = "replicated") -> str:
    """The parameters' layout over the ranks: ``'replicated'`` (each rank
    holds them whole, DDP averages the gradients) is the one this slice
    runs; ``'zero1'``, ``'fsdp'`` and ``'tp'`` raise, naming slice 7b."""
    if mode not in PARAM_SHARDINGS:
        raise ValueError(f"unknown param_sharding {mode!r} (expected one of {PARAM_SHARDINGS})")
    if mode != "replicated":
        raise NotImplementedError(
            f"param_sharding {mode!r}: parameter sharding (ZeRO-1, FSDP, tensor parallelism) "
            "comes with slice 7b of the port; this slice runs 'replicated' (DDP)")
    return mode


def host_local_batch_slice(global_batch_size: int) -> tuple[int, int]:
    """``(start, size)`` of this rank's contiguous block of a global batch:
    the JAX package's host slice, and what ``DistributedSampler`` hands the
    reference's ranks.  Raises when the world does not divide the batch
    (truncating would drop samples from every batch)."""
    world = world_size()
    if global_batch_size % world:
        raise ValueError(f"global batch {global_batch_size} does not divide evenly over "
                         f"{world} processes")
    per = global_batch_size // world
    return rank() * per, per


def wrap_data_parallel(module: torch.nn.Module, device: torch.device
                       ) -> DistributedDataParallel:
    """``module`` (already on ``device``) in ``DistributedDataParallel``
    over the initialised group: ``device_ids=[device.index]`` on CUDA, none
    on the CPU.  DDP broadcasts rank 0's parameters and buffers now, and
    its buffers again before every forward (``broadcast_buffers``, so a
    per-rank BatchNorm's running statistics follow rank 0's); every
    parameter must take a gradient in every step
    (``find_unused_parameters=False``)."""
    if not dist.is_initialized():
        raise RuntimeError("wrap_data_parallel needs an initialised process group "
                           "(bvc_tpu_torch.parallel.distributed_init)")
    device = torch.device(device)
    ids = [device.index if device.index is not None else torch.cuda.current_device()] \
        if device.type == "cuda" else None
    return DistributedDataParallel(module, device_ids=ids, broadcast_buffers=True,
                                   find_unused_parameters=False)
