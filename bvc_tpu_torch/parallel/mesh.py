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

The mesh carries up to four axes, ``data``, ``seq``, ``model`` and
``pipe`` (``--mesh data=N[,seq=S][,model=M]`` over N*S*M processes, or
``--mesh data=N,pipe=P`` over N*P).  A rank's coordinates follow the JAX
package's row-major layout of the devices: ``data`` outermost, then
``seq``, ``model``, and ``pipe`` fastest (``make_pipe_mesh`` puts it
innermost, so neighbouring stages are neighbouring ranks), so rank ``r``
sits at ``data = r // (S*M)``, ``seq = (r // M) % S``, ``model = r % M``
on a mesh without ``pipe``, and at ``data = r // P``, ``pipe = r % P`` on a
pipe mesh.  :func:`make_mesh` builds, for each axis, one process group of
the ranks that share every other coordinate: the ``data`` group (the batch
is split over it), the ``seq`` ring (the ranks of one block of batch rows
and one block of heads, each holding a slice of the time axis), the
``model`` group (the ranks that hold the same tokens and split the heads
under ``tp``) and the ``pipe`` group (the stages of one block of batch
rows, :mod:`bvc_tpu_torch.parallel.pipeline`); on a mesh with ``seq``,
also the gradient group of the ranks that share a ``model`` coordinate
(``data`` x ``seq``: the JAX package ``pmean``s the gradients over both).
It records the mesh as the process's own (:func:`current_mesh`), which the
collectives, the batch slicing and the steps read.

A ``pipe`` axis runs beside ``data`` only.  The JAX package's steps leave
a ``seq`` or ``model`` axis beside ``pipe`` out of their ``shard_map``, so
every device on it repeats the whole step (and its trainer takes the seq
step, ignoring ``pipe``, when both are there): :func:`check_axes` refuses
the combination rather than copy that accident.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from bvc_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
AXES = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS, PIPE_AXIS)  # in the order of the ranks' layout
GRADIENT = "gradient"  # the key of the gradient group (data x seq) in Mesh.groups
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
    ``seq``, ``model`` or ``pipe`` when they were asked for), this rank's coordinate
    on each axis, and the process group of each axis that this rank belongs
    to (None where the axis spans the whole world, or where there is no
    group)."""

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

    def gradient_group(self):
        """The group the gradients are averaged over: the ranks that share
        this rank's ``model`` coordinate, ``data`` x ``seq`` (the ``data``
        group on a mesh without ``seq``)."""
        return self.groups.get(GRADIENT) if SEQ_AXIS in self.shape else self.group(DATA_AXIS)

    def gradient_size(self) -> int:
        """Ranks in :meth:`gradient_group`."""
        return self.axis_size(DATA_AXIS) * self.axis_size(SEQ_AXIS)


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


def check_axes(shape: dict[str, int]) -> None:
    """Raise for an axis the port does not know, and for a ``pipe`` axis
    beside ``seq`` or ``model`` (see the module's doc)."""
    for axis in shape:
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r} in {shape}")
    if PIPE_AXIS in shape and (SEQ_AXIS in shape or MODEL_AXIS in shape):
        raise ValueError(
            f"mesh {shape}: a '{PIPE_AXIS}' axis runs beside '{DATA_AXIS}' only "
            f"(--mesh data=N,pipe=P).  The JAX package's steps leave a '{SEQ_AXIS}' or "
            f"'{MODEL_AXIS}' axis beside '{PIPE_AXIS}' out of their shard_map, so every "
            "device on it repeats the whole step (its trainer takes the seq step and "
            f"ignores '{PIPE_AXIS}' when both are there): there is no layout to port")


def _coords(rk: int, names: list[str], sizes: dict[str, int]) -> dict[str, int]:
    """Rank ``rk``'s coordinate on each axis of ``names`` (the last fastest)."""
    out = {}
    for a in reversed(names):
        rk, out[a] = divmod(rk, sizes[a])
    return {a: out[a] for a in names}


def _axis_groups(sizes: dict[str, int]) -> dict[str, object]:
    """The process group of each axis holding this rank, over a world laid
    out ``data``-major (the last axis of :data:`AXES` fastest): for each
    axis, the ranks that share every other coordinate, and on a mesh with
    ``seq`` the gradient group of the ranks that share the ``model``
    coordinate.  Every rank creates every group, in the same order, as
    ``new_group`` requires; a group that spans the world is the world's
    (None), and a ``seq``, ``model`` or ``pipe`` axis of 1 gets none
    (nothing runs over it)."""
    names = [a for a in AXES if a in sizes]
    world, r = math.prod(sizes.values()), rank()
    groups: dict[str, object] = {}
    for key, vary in ((DATA_AXIS, {DATA_AXIS}), (SEQ_AXIS, {SEQ_AXIS}),
                      (MODEL_AXIS, {MODEL_AXIS}), (PIPE_AXIS, {PIPE_AXIS}),
                      (GRADIENT, {DATA_AXIS, SEQ_AXIS})):
        if not vary <= set(names):
            continue
        if math.prod(sizes[a] for a in vary) == world:
            groups[key] = None
            continue
        if key in (SEQ_AXIS, MODEL_AXIS, PIPE_AXIS) and sizes[key] == 1:
            continue
        members: dict[tuple, list[int]] = {}
        for rk in range(world):
            c = _coords(rk, names, sizes)
            members.setdefault(tuple(c[a] for a in names if a not in vary), []).append(rk)
        for ranks in members.values():  # insertion order: the same on every rank
            g = dist.new_group(ranks)
            if r in ranks:
                groups[key] = g
    return groups


def make_mesh(shape: dict[str, int] | None = None) -> Mesh:
    """The mesh of ``shape`` (e.g. ``{'data': 2, 'model': 2}``,
    ``{'data': 1, 'seq': 2}`` or ``{'data': 2, 'pipe': 2}``) over the process group, recorded as the
    process's mesh (:func:`current_mesh`).

    Empty or None puts every rank on ``data``; a missing ``data`` axis is
    ``-1``, and one ``-1`` is inferred from the world size, as the JAX
    package infers it.  The sizes must multiply to the world size:
    ``--mesh data=2`` or ``data=1,model=2`` in one process raises rather
    than running one rank.  A ``pipe`` axis beside ``seq`` or ``model``
    raises (:func:`check_axes`).  The axes are always laid out
    ``data``-major.  Asked again for the layout it holds, in the same live
    process group, it returns that mesh and builds no new groups (every
    stage of a curriculum asks)."""
    global _CURRENT
    shape = dict(shape or {DATA_AXIS: -1})
    check_axes(shape)
    world = world_size()
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        raise RuntimeError(f"WORLD_SIZE={os.environ['WORLD_SIZE']} but no process group is "
                           "initialised: call bvc_tpu_torch.parallel.distributed_init() first")
    names = tuple(a for a in AXES if a == DATA_AXIS or a in shape)
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
    coords = _coords(rank(), list(names), sizes)
    groups = _axis_groups(sizes) if dist.is_initialized() else {}
    _CURRENT = Mesh(names, sizes, coords, groups, dist.group.WORLD)
    return _CURRENT
