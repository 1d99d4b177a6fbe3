"""Collectives across the ranks of the process group (counterpart of
:mod:`bvc_tpu.parallel.collectives`, and of the two Megatron operators of
:mod:`bvc_tpu.parallel.seqpar`).

Over the ``data`` axis of the process's mesh
(:func:`~bvc_tpu_torch.parallel.mesh.current_mesh`; the world on a pure
data mesh):

- :func:`all_gather_objects`: every data rank's result dict on every rank
  (the extraction's rows, ``compute_embeddings --resume``'s list);
- :func:`all_gather_grad`: a gather of every data rank's rows that carries
  the gradient back to each rank's slice (SimCLR's global negatives);
- :func:`all_reduce_grad`: a sum over the data ranks that carries the
  summed gradient back to every rank (cross-rank BatchNorm statistics);
- :func:`psum_scalar`: the mean of values over the data ranks (the steps'
  metrics).

Over a ``model`` group, for the head-parallel blocks of ``tp``
(:mod:`bvc_tpu_torch.models.vit`, which hold their group):

- :func:`copy_to_model`: identity forward, a sum of the gradient over the
  model ranks backward (Megatron's "f", JAX's ``_ident_fwd_psum_bwd``);
- :func:`reduce_from_model`: a sum over the model ranks forward, identity
  backward (Megatron's "g", JAX's ``_psum_fwd_ident_bwd``).

:func:`sync_hosts` is a barrier of the whole world around checkpoint
writes.  Each runs the same collectives on every rank of its group,
whatever a rank holds, so a rank with nothing to send cannot leave its
peers waiting in another call.  Over a data axis of one rank (or without
an initialised group) the data collectives return their input.

The differentiable ones are written here rather than taken from
``torch.distributed.nn.functional``, which PyTorch deprecates: their
backward is one ``all_reduce``, which NCCL and gloo both run.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from bvc_tpu_torch.parallel.mesh import DATA_AXIS, current_mesh, world_size

def axis_group(axis: str) -> tuple[Any, int, int]:
    """``(group, size, rank in it)`` of this rank's group on ``axis`` of
    the process's mesh."""
    mesh = current_mesh()
    return mesh.group(axis), mesh.axis_size(axis), mesh.coord(axis)


def all_gather_objects(data: Any) -> list[Any]:
    """``data`` (any picklable value: a dict of fname lists and row arrays,
    a list of phases) of every data rank, in data order, on every rank; one
    ``all_gather_object`` whatever each rank holds, so an empty list or a
    zero-row array on one rank cannot desynchronise the others."""
    group, size, _ = axis_group(DATA_AXIS)
    if size == 1:
        return [data]
    out: list[Any] = [None] * size
    dist.all_gather_object(out, data, group=group)
    return out


class _GatherRows(torch.autograd.Function):
    """Forward: every data rank's ``[b, ...]`` rows concatenated in data
    order.  Backward: the gradient of the whole ``[size * b, ...]`` result
    summed over the data ranks, this rank's rows kept (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        group, size, r = axis_group(DATA_AXIS)
        x = x.contiguous()
        out = x.new_empty((size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        ctx.rows, ctx.group, ctx.rank = x.shape[0], group, r
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        start = ctx.rank * ctx.rows
        return grad[start:start + ctx.rows]


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _SumOverRanks(torch.autograd.Function):
    """Forward and backward: a sum over the ranks of ``group``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _summed(grad, ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over ``group`` backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _summed(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """A sum over ``group`` forward; the gradient as it is backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def all_gather_grad(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows of ``x`` concatenated in data order,
    differentiable: the counterpart of ``lax.all_gather(..., tiled=True)``
    and the reference's ``AllGather`` (forward gather, backward
    reduce-scatter).  When every rank computes the same loss of the whole
    result, each rank's gradient is ``size`` times its share, which
    DistributedDataParallel's mean over the data ranks divides out."""
    return x if axis_group(DATA_AXIS)[1] == 1 else _GatherRows.apply(x)


def all_reduce_grad(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data ranks, differentiable (the backward
    sums the gradient over them too)."""
    group, size, _ = axis_group(DATA_AXIS)
    return x if size == 1 else _SumOverRanks.apply(x, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's "f" over the model ranks of ``group``: ``x`` as it is, its
    gradient summed over the ranks.  It enters a column-parallel layer,
    whose rank-local outputs each carry part of ``x``'s gradient."""
    return _CopyToGroup.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's "g" over the model ranks of ``group``: the sum of the
    ranks' partial ``x``, the gradient passed through.  It leaves a
    row-parallel layer, whose rank-local products sum to the whole one."""
    return _ReduceFromGroup.apply(x, group)


def psum_scalar(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data ranks (the reference's
    ``AllReduce`` of the loss); a new tensor, no gradient."""
    group, size, _ = axis_group(DATA_AXIS)
    if size == 1:
        return x
    return _summed(x.detach(), group) / size


def sync_hosts() -> None:
    """Barrier across every rank (a no-op without a group)."""
    if world_size() > 1:
        dist.barrier()
