"""How batches and parameters map onto the ranks (counterpart of
:mod:`bvc_tpu.parallel.sharding`, and of the train state's layouts in
:mod:`bvc_tpu.training.steps`).

The JAX package gives parameters a ``NamedSharding`` and shards the batch
over ``data``; XLA emits the collectives.  The port runs one process per
GPU, each holding its ``data`` coordinate's contiguous block of every
global batch (:func:`host_local_batch_slice`), and lays the parameters out
by one of the JAX package's four modes (:func:`param_shardings`):

- ``replicated``: every rank holds the whole model inside
  ``DistributedDataParallel`` over the ``data`` group, whose bucket hooks
  average the gradients during the backward (the reference's DDP);
- ``zero1``: as ``replicated``, and the optimizer's state partitioned over
  the ``data`` ranks (``ZeroRedundancyOptimizer``: each rank steps the
  whole tensors it owns and broadcasts them);
- ``fsdp``: every transformer block (ResNet block) and the root module
  under FSDP2's ``fully_shard`` over the ``data`` ranks: each parameter a
  ``DTensor`` sharded on dim 0, gathered around its use, its gradient
  reduce-scattered; no DDP;
- ``tp``: the blocks' attention heads and MLP columns split over the
  ``model`` ranks (:data:`TP_RULES`, the JAX package's ``_TP_RULES`` in
  ``nn.Linear`` layout, which each block applies to itself:
  :meth:`bvc_tpu_torch.models.vit.Block.split_heads`), Megatron's two
  collectives in the blocks, DDP over the ``data`` group.  A
  parameter that matches no rule (LayerNorm, patch embedding, positions,
  ``enc_to_dec``, heads, a ResNet) stays whole on every model rank.

Whatever the mode, :func:`full_tensor` and :func:`local_part` move a
parameter (or its gradient, or an optimizer state of its layout) between
the rank's part and the whole tensor, so checkpoints hold whole tensors in
one layout and resume under any mode.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from bvc_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh, current_mesh, data_rank,
                                         data_size)

PARAM_SHARDINGS = ("replicated", "zero1", "fsdp", "tp")

# (parameter name suffix, dim split, parts): torch's nn.Linear weight is
# [out, in], so the JAX package's column-parallel kernels ([.., D, 3D'],
# split on their last dim) split on dim 0 here and its row-parallel ones
# ([.., D', D], split on dim -2) on dim 1.  The fused qkv rows are ordered
# [3, H, hd]: each of its 3 parts is split, so a rank holds its heads of q,
# k and v (and of their biases, the k third included).
TP_RULES: tuple[tuple[str, int, int], ...] = (
    ("qkv.weight", 0, 3),   # column parallel (heads)
    ("qkv.bias", 0, 3),
    ("proj.weight", 1, 1),  # row parallel; its bias is added after the sum
    ("fc1.weight", 0, 1),   # column parallel
    ("fc1.bias", 0, 1),
    ("fc2.weight", 1, 1),   # row parallel; its bias is added after the sum
)


@dataclass(frozen=True)
class ShardingPlan:
    """Which mesh axis splits what under a mode: ``params`` the parameters
    (and their gradients and optimizer state: ``'data'`` under ``fsdp``,
    ``'model'`` under ``tp``), ``optimizer`` the optimizer state alone
    (``'data'`` under ``zero1``); None keeps it whole on every rank."""

    mode: str
    params: str | None = None
    optimizer: str | None = None


def param_shardings(mode: str = "replicated", mesh: Mesh | None = None) -> ShardingPlan:
    """The plan of ``mode`` on ``mesh`` (the process's mesh when None).

    ``tp`` without a ``model`` axis of more than one rank is the replicated
    layout, as in the JAX package, whose rules then shard over nothing.
    ``zero1`` and ``fsdp`` on a mesh with ``model > 1`` raise: the JAX
    package accepts the combination (sharding over ``data`` while ``model``
    replicates), but nothing runs it and the port has no layout for it."""
    if mode not in PARAM_SHARDINGS:
        raise ValueError(f"unknown param_sharding {mode!r} (expected one of {PARAM_SHARDINGS})")
    mesh = mesh if mesh is not None else current_mesh()
    n_model = mesh.axis_size(MODEL_AXIS)
    if mode in ("zero1", "fsdp") and n_model > 1:
        raise NotImplementedError(
            f"param_sharding {mode!r} on a mesh with model={n_model}: the port splits "
            f"{mode}'s state over 'data' only; use --mesh data=N with {mode}, or "
            "--param_sharding tp with a model axis")
    if mode == "zero1":
        return ShardingPlan(mode, optimizer=DATA_AXIS)
    if mode == "fsdp":
        return ShardingPlan(mode, params=DATA_AXIS)
    if mode == "tp" and n_model > 1:
        return ShardingPlan(mode, params=MODEL_AXIS)
    return ShardingPlan(mode)


def host_local_batch_slice(global_batch_size: int) -> tuple[int, int]:
    """``(start, size)`` of this rank's contiguous block of a global batch:
    the block of its ``data`` coordinate, the JAX package's host slice and
    what ``DistributedSampler`` hands the reference's ranks.  The ranks of
    one data row (``model`` ranks) hold the same block.  Raises when the
    data axis does not divide the batch (truncating would drop samples from
    every batch)."""
    n = data_size()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} does not divide evenly over "
                         f"{n} data ranks")
    per = global_batch_size // n
    return data_rank() * per, per


def wrap_data_parallel(module: torch.nn.Module, device: torch.device, group=None
                       ) -> DistributedDataParallel:
    """``module`` (already on ``device``) in ``DistributedDataParallel``
    over ``group`` (the world's when None): ``device_ids=[device.index]``
    on CUDA, none on the CPU.  DDP broadcasts the group's first rank's
    parameters and buffers now, and its buffers again before every forward
    (``broadcast_buffers``, so a per-rank BatchNorm's running statistics
    follow it); every parameter must take a gradient in every step
    (``find_unused_parameters=False``)."""
    if not dist.is_initialized():
        raise RuntimeError("wrap_data_parallel needs an initialised process group "
                           "(bvc_tpu_torch.parallel.distributed_init)")
    device = torch.device(device)
    ids = [device.index if device.index is not None else torch.cuda.current_device()] \
        if device.type == "cuda" else None
    return DistributedDataParallel(module, device_ids=ids, broadcast_buffers=True,
                                   find_unused_parameters=False, process_group=group)


# ------------------------------------------------------------------ tp


@dataclass(frozen=True)
class TPSplit:
    """How a parameter of a head-parallel block lies over the ``model``
    ranks: ``dim`` split in ``size`` equal chunks within each of its
    ``parts`` (3 for the fused qkv), this rank's the ``rank``-th."""

    dim: int
    parts: int
    size: int
    rank: int
    group: object

    def split(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``full``."""
        chunks = full.unflatten(self.dim, (self.parts, -1)).chunk(self.size, self.dim + 1)
        return chunks[self.rank].flatten(self.dim, self.dim + 1).contiguous()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's part (an all-gather)."""
        local = local.contiguous()
        pieces = [torch.empty_like(local) for _ in range(self.size)]
        dist.all_gather(pieces, local, group=self.group)
        return torch.cat([p.unflatten(self.dim, (self.parts, -1)) for p in pieces],
                         self.dim + 1).flatten(self.dim, self.dim + 1)


def shard_heads(module: torch.nn.Module, mesh: Mesh) -> None:
    """Split every transformer block of ``module`` (each module with a
    ``split_heads``) over the ``model`` ranks of ``mesh`` by
    :data:`TP_RULES`: its parameters become this rank's parts (tagged
    ``tp_split``) and the block runs its heads and MLP columns with
    Megatron's collectives.  A block whose heads or MLP width do not divide
    by the axis stays whole."""
    size, r, group = mesh.axis_size(MODEL_AXIS), mesh.coord(MODEL_AXIS), mesh.group(MODEL_AXIS)
    for block in module.modules():
        split = getattr(block, "split_heads", None)
        if split is not None:
            split(group, size, r)


# ---------------------------------------------------------------- fsdp


def shard_fully(module: torch.nn.Module, device: torch.device, mesh: Mesh) -> torch.nn.Module:
    """FSDP2's ``fully_shard`` over the ``data`` ranks of ``mesh`` on each
    block of ``module`` (each module whose class sets ``shard_unit``: the
    transformer and ResNet blocks), then on ``module`` (which takes the
    rest: embeddings, norms, heads), its weights in contiguous memory
    first.  Returns ``module``, now an ``FSDPModule``: call it (its hooks
    gather the parameters), not its methods."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.fsdp import fully_shard

    group = mesh.group(DATA_AXIS) or dist.group.WORLD
    dm = DeviceMesh.from_group(group, torch.device(device).type, mesh_dim_names=(DATA_AXIS,))
    module.to(memory_format=torch.contiguous_format)  # FSDP2 takes no channels_last weight
    for block in [m for m in module.modules() if getattr(m, "shard_unit", False)]:
        fully_shard(block, mesh=dm)
    return fully_shard(module, mesh=dm)


# ------------------------------------------------------- whole <-> part


def resharded(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` with its parameters back in their shards: FSDP2 leaves a
    root module's gathered after a forward that no backward follows (the
    JEPA target encoder's, an eval step's).  A no-op for other layouts."""
    reshard = getattr(module, "reshard", None)
    if reshard is not None:
        reshard()
    return module


def _dtensor_cls():
    from torch.distributed.tensor import DTensor

    return DTensor


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The rank's own part of ``t``: a ``DTensor``'s local shard, else
    ``t``."""
    return t.to_local() if isinstance(t, _dtensor_cls()) else t


def shard_group(p: torch.Tensor):
    """``(True, group)`` when ``p`` is split over the ranks of ``group``
    (``fsdp``: its mesh's; ``tp``: the model ranks'), ``(False, None)``
    when every rank holds it whole."""
    if isinstance(p, _dtensor_cls()):
        return True, p.device_mesh.get_group()
    spec = getattr(p, "tp_split", None)
    return (True, spec.group) if spec is not None else (False, None)


def _dim0_rows(n: int, size: int, r: int) -> tuple[int, int]:
    """``(start, stop)`` of rank ``r``'s rows of an ``n``-row tensor split
    on dim 0 over ``size`` ranks as FSDP2 splits it (``torch.chunk``: pieces
    of ``ceil(n / size)`` rows, the last short, the ones past it empty)."""
    per = -(-n // size)
    return min(r * per, n), min((r + 1) * per, n)


def _gather_dim0(t, group) -> torch.Tensor:
    """The whole tensor of a ``DTensor`` split on dim 0 (FSDP2's layout),
    by one ``all_gather_into_tensor`` of the parts padded to equal rows.
    DTensor's own ``full_tensor`` goes through functional collectives,
    which crash over gloo on CUDA tensors (torch 2.11)."""
    from torch.distributed.tensor import Shard

    if tuple(t.placements) != (Shard(0),):
        raise NotImplementedError(f"a DTensor placed {t.placements}: only Shard(0) is gathered")
    local, n = t.to_local(), t.shape[0]
    size = dist.get_world_size(group)
    per = -(-n // size)
    padded = local.new_zeros((per, *local.shape[1:]))
    padded[:local.shape[0]] = local
    out = local.new_empty((size * per, *local.shape[1:]))
    dist.all_gather_into_tensor(out, padded, group=group)
    return out[:n]


def full_tensor(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``t`` (``p`` itself, its gradient, or an
    optimizer state of ``p``'s layout) holds this rank's part: a
    collective over ``p``'s ranks when ``p`` is split, ``t`` itself when
    not."""
    if isinstance(t, _dtensor_cls()):
        return _gather_dim0(t, t.device_mesh.get_group())
    spec = getattr(p, "tp_split", None)
    return t if spec is None else spec.gather(t)


def local_part(p: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``full`` in ``p``'s layout (a ``DTensor`` under
    ``fsdp``, the rank's chunk under ``tp``), on ``p``'s device; every rank
    holds ``full``, so no collective runs."""
    full = full.to(p.device)
    if isinstance(p, _dtensor_cls()):
        group = p.device_mesh.get_group()
        lo, hi = _dim0_rows(full.shape[0], dist.get_world_size(group), dist.get_rank(group))
        return _dtensor_cls().from_local(full[lo:hi].contiguous(), p.device_mesh, p.placements,
                                         run_check=False, shape=full.shape,
                                         stride=full.stride())
    spec = getattr(p, "tp_split", None)
    return full if spec is None else spec.split(full)


def full_state_dict(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """``module.state_dict()`` with every parameter whole, whatever the
    layout: a collective on every rank (each ends with the whole tensors),
    in the state dict's order."""
    params = dict(resharded(module).named_parameters())
    return {k: full_tensor(params[k], v) if k in params else v
            for k, v in module.state_dict().items()}


def load_full_state_dict(module: torch.nn.Module, sd: dict[str, torch.Tensor]) -> None:
    """Load a state dict of whole tensors (:func:`full_state_dict`, a
    checkpoint) into ``module``, each rank taking its parts."""
    params = dict(resharded(module).named_parameters())
    module.load_state_dict({k: local_part(params[k], v) if k in params else v
                            for k, v in sd.items()})
