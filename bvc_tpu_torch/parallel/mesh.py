"""The distributed runtime: one process per GPU under ``torch.distributed``
(counterpart of :mod:`bvc_tpu.parallel.mesh`).

JAX runs one process per host over a ``Mesh`` of every device, and XLA
inserts the collectives.  The port runs as the reference does: one process
per GPU, a process group (NCCL on ``cuda``, gloo for CPU tensors) and
``DistributedDataParallel`` (:mod:`bvc_tpu_torch.parallel.sharding`).  A
rank's batch flag is per GPU, so the global batch is ``batch_size *
world``, as the JAX CLIs' per-device flag makes it.

Launch with torchrun, which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``::

    torchrun --nproc_per_node 4 -m bvc_tpu_torch.cli.pretrain_videomae \\
        --mesh data=4 ...

or, as the JAX package's launcher, with ``BVC_COORDINATOR=host:port``,
``SLURM_NTASKS`` and ``SLURM_PROCID`` (``SLURM_LOCALID`` names the GPU).

The mesh carries up to two axes, ``data`` and ``model`` (``--mesh
data=N,model=M`` over N*M processes).  A rank's coordinates follow the
JAX package's row-major layout of the devices: ``model`` varies fastest, so
rank ``r`` sits at ``data = r // M``, ``model = r % M``.  :func:`make_mesh`
builds one process group per model column (the ranks that share a
``model`` coordinate: the batch is split and the gradients averaged over
it) and one per data row (the ranks that share a ``data`` coordinate: they
hold the same batch and split the heads under ``tp``), and records the mesh
as the process's own (:func:`current_mesh`), which the collectives, the
batch slicing and the steps read.  The JAX package's other axes, ``seq``
and ``pipe``, come with slices 7c and 7d of the port and raise until then.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from bvc_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the JAX package's other mesh axes, and the slice of the port that brings each
UNPORTED_AXES = {"seq": "7c (sequence parallelism)", "pipe": "7d (the pipeline)"}
_TORCHRUN = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def world_size() -> int:
    """Processes in the initialised group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the initialised group; 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _rendezvous() -> dict | None:
    """``{init_method, world_size, rank, local_rank}`` from the launcher's
    environment, or None when no launcher variable is set.  A variable set
    without the others it needs raises: no run quietly becomes a smaller
    world."""
    env = os.environ
    if env.get("BVC_COORDINATOR"):
        missing = [k for k in ("SLURM_NTASKS", "SLURM_PROCID") if k not in env]
        if missing:
            raise RuntimeError(f"BVC_COORDINATOR is set but {', '.join(missing)} is not")
        return {"init_method": f"tcp://{env['BVC_COORDINATOR']}",
                "world_size": int(env["SLURM_NTASKS"]), "rank": int(env["SLURM_PROCID"]),
                "local_rank": int(env.get("SLURM_LOCALID", env.get("LOCAL_RANK", 0)))}
    present = [k for k in _TORCHRUN if k in env]
    if not present:
        return None
    missing = [k for k in _TORCHRUN if k not in env]
    if missing:
        raise RuntimeError(f"{', '.join(present)} set but {', '.join(missing)} not: launch "
                           "with torchrun, which sets all five")
    return {"init_method": "env://", "world_size": int(env["WORLD_SIZE"]),
            "rank": int(env["RANK"]), "local_rank": int(env["LOCAL_RANK"])}


def distributed_init(backend: str | None = None,
                     device: str | torch.device | None = None) -> None:
    """Join the process group the launcher's environment describes
    (torchrun's variables, or ``BVC_COORDINATOR`` with ``SLURM_NTASKS`` and
    ``SLURM_PROCID``).

    ``backend`` None takes NCCL when ``device`` is CUDA (``cuda`` when None)
    and gloo when it is the CPU.  On NCCL the process's GPU becomes
    ``cuda:LOCAL_RANK`` first (:func:`torch.cuda.set_device`); gloo also
    serves CUDA tensors (several ranks on one card), and a caller names it
    to get it.  Does nothing when no launcher variable is set (one
    process) or when a group already exists."""
    if dist.is_initialized():
        return
    rdv = _rendezvous()
    if rdv is None:
        return
    on_cuda = resolve_device(device).type == "cuda"
    if backend is None:
        backend = "nccl" if on_cuda else "gloo"
    if on_cuda:
        torch.cuda.set_device(rdv["local_rank"])
    dist.init_process_group(backend, init_method=rdv["init_method"],
                            world_size=rdv["world_size"], rank=rdv["rank"])


@dataclass(frozen=True)
class Mesh:
    """The layout of the processes: axis names and sizes (``data``, and
    ``model`` when one was asked for), this rank's coordinate on each axis,
    and the process group of each axis that this rank belongs to (None
    where the axis spans the whole world, or where there is no group)."""

    axis_names: tuple[str, ...]
    shape: dict[str, int]
    coords: dict[str, int] = field(default_factory=dict)
    groups: dict[str, object] = field(default_factory=dict)
    world: object = None  # the world's process group the axes' groups were built in

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of ``axis`` that holds this rank (None: the
        world's, or no group at all)."""
        return self.groups.get(axis)


_CURRENT: Mesh | None = None


def _live(mesh: Mesh | None) -> bool:
    """Whether ``mesh`` was built in the process group that lives now."""
    return (mesh is not None and dist.is_initialized() and mesh.world is dist.group.WORLD
            and mesh.size == world_size())


def current_mesh() -> Mesh:
    """The mesh :func:`make_mesh` built last, while its process group
    lives; else every rank on ``data`` (a pure data mesh over the world,
    or one process)."""
    if _live(_CURRENT):
        return _CURRENT
    return Mesh((DATA_AXIS,), {DATA_AXIS: world_size()}, {DATA_AXIS: rank()})


def data_size() -> int:
    """Ranks on ``data``: the count of blocks a global batch is split into."""
    return current_mesh().axis_size(DATA_AXIS)


def data_rank() -> int:
    """This rank's ``data`` coordinate: which block of a global batch it holds."""
    return current_mesh().coord(DATA_AXIS)


def refuse_unported_axes(shape: dict[str, int]) -> None:
    """Raise for a mesh axis the port does not run yet, naming its slice."""
    for axis in shape:
        if axis in UNPORTED_AXES:
            raise NotImplementedError(
                f"mesh axis {axis!r} ({shape}): it comes with slice {UNPORTED_AXES[axis]} "
                "of the port; this slice runs data and model axes (--mesh data=N,model=M)")
        if axis not in (DATA_AXIS, MODEL_AXIS):
            raise ValueError(f"unknown mesh axis {axis!r} in {shape}")


def _axis_groups(sizes: tuple[int, int]) -> dict[str, object]:
    """The process group of each axis holding this rank, over a world laid
    out ``data``-major (``model`` fastest).  Every rank creates every group,
    in the same order, as ``new_group`` requires; an axis that spans the
    world takes the world's group (None), and a ``model`` axis of 1 none."""
    n_data, n_model = sizes
    r = rank()
    groups: dict[str, object] = {}
    if n_model == 1:
        return {DATA_AXIS: None}
    for m in range(n_model):  # model columns: the ranks that share a model coordinate
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if r % n_model == m:
            groups[DATA_AXIS] = g
    if n_data == 1:
        groups[MODEL_AXIS] = None
        return groups
    for d in range(n_data):  # data rows: the ranks that share a data coordinate
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if r // n_model == d:
            groups[MODEL_AXIS] = g
    return groups


def make_mesh(shape: dict[str, int] | None = None) -> Mesh:
    """The mesh of ``shape`` (e.g. ``{'data': 2, 'model': 2}``) over the
    process group, recorded as the process's mesh (:func:`current_mesh`).

    Empty or None puts every rank on ``data``; a missing ``data`` axis is
    ``-1``, and one ``-1`` is inferred from the world size, as the JAX
    package infers it.  The sizes must multiply to the world size:
    ``--mesh data=2`` or ``data=1,model=2`` in one process raises rather
    than running one rank.  A ``seq`` or ``pipe`` axis raises and names the
    slice of the port that brings it.  The axes are always laid out
    ``data``-major.  Asked again for the layout it holds, in the same live
    process group, it returns that mesh and builds no new groups (every
    stage of a curriculum asks)."""
    global _CURRENT
    shape = dict(shape or {DATA_AXIS: -1})
    refuse_unported_axes(shape)
    world = world_size()
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        raise RuntimeError(f"WORLD_SIZE={os.environ['WORLD_SIZE']} but no process group is "
                           "initialised: call bvc_tpu_torch.parallel.distributed_init() first")
    names = (DATA_AXIS, MODEL_AXIS) if MODEL_AXIS in shape else (DATA_AXIS,)
    sizes = {a: shape.get(a, -1) for a in names}
    if list(sizes.values()).count(-1) > 1:
        raise ValueError(f"mesh {shape}: at most one axis may be -1")
    for a, n in sizes.items():
        if n == -1:
            known = math.prod(v for v in sizes.values() if v != -1)
            if world % known:
                raise ValueError(f"mesh {shape}: {world} processes do not divide by {known}")
            sizes[a] = world // known
        elif n < 1:
            raise ValueError(f"mesh {shape}: axis {a!r} has size {n}")
    need = math.prod(sizes.values())
    if need != world:
        what = f"data={need}" if names == (DATA_AXIS,) else str(sizes)
        raise ValueError(f"mesh {what} needs {need} processes, this run has {world}: launch "
                         f"with torchrun --nproc_per_node {need} (one process per GPU)")
    if _live(_CURRENT) and (_CURRENT.axis_names, _CURRENT.shape) == (names, sizes):
        return _CURRENT  # the same layout: its groups serve (new ones would leak)
    n_model = sizes.get(MODEL_AXIS, 1)
    r = rank()
    coords = {DATA_AXIS: r // n_model}
    if MODEL_AXIS in sizes:
        coords[MODEL_AXIS] = r % n_model
    groups = _axis_groups((sizes[DATA_AXIS], n_model)) if dist.is_initialized() else {}
    _CURRENT = Mesh(names, sizes, coords, groups, dist.group.WORLD)
    return _CURRENT
