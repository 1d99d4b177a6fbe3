"""Collectives across the ranks of the process group (counterpart of
:mod:`bvc_tpu.parallel.collectives`).

- :func:`all_gather_objects`: every rank's result dict on every rank (the
  extraction's rows, ``compute_embeddings --resume``'s list);
- :func:`all_gather_grad`: a gather of every rank's rows that carries the
  gradient back to each rank's slice (SimCLR's global negatives);
- :func:`all_reduce_grad`: a sum over ranks that carries the summed
  gradient back to every rank (cross-rank BatchNorm statistics);
- :func:`psum_scalar`: the mean of values over ranks (the steps' metrics);
- :func:`sync_hosts`: a barrier around checkpoint writes.

Each runs the same collectives on every rank, whatever a rank holds, so a
rank with nothing to send cannot leave its peers waiting in another call.
Without an initialised group each returns its input (one process).

The two differentiable ones are written here rather than taken from
``torch.distributed.nn.functional``, which PyTorch deprecates: their
backward is one ``all_reduce``, which NCCL and gloo both run.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from bvc_tpu_torch.parallel.mesh import rank, world_size


def all_gather_objects(data: Any) -> list[Any]:
    """``data`` (any picklable value: a dict of fname lists and row arrays,
    a list of phases) of every rank, in rank order, on every rank; one
    ``all_gather_object`` whatever each rank holds, so an empty list or a
    zero-row array on one rank cannot desynchronise the others."""
    world = world_size()
    if world == 1:
        return [data]
    out: list[Any] = [None] * world
    dist.all_gather_object(out, data)
    return out


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's ``[b, ...]`` rows concatenated in rank order.
    Backward: the gradient of the whole ``[world * b, ...]`` result summed
    over ranks, this rank's rows kept (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        out = x.new_empty((world_size() * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x)
        ctx.rows = x.shape[0]
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        start = rank() * ctx.rows
        return grad[start:start + ctx.rows]


class _SumOverRanks(torch.autograd.Function):
    """Forward and backward: a sum over ranks (``all_reduce``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = x.contiguous().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def all_gather_grad(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` concatenated in rank order,
    differentiable: the counterpart of ``lax.all_gather(..., tiled=True)``
    and the reference's ``AllGather`` (forward gather, backward
    reduce-scatter).  When every rank computes the same loss of the whole
    result, each rank's gradient is ``world`` times its share, which
    DistributedDataParallel's mean over ranks divides out."""
    return x if world_size() == 1 else _GatherRows.apply(x)


def all_reduce_grad(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ranks, differentiable (the backward sums the
    gradient over ranks too)."""
    return x if world_size() == 1 else _SumOverRanks.apply(x)


def psum_scalar(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over ranks (the reference's ``AllReduce`` of the
    loss); a new tensor, no gradient."""
    world = world_size()
    if world == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out / world


def sync_hosts() -> None:
    """Barrier across ranks (a no-op without a group)."""
    if world_size() > 1:
        dist.barrier()
