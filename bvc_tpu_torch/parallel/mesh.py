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

The mesh carries one axis here, ``data``.  The others of the JAX package
(``model``, ``seq``, ``pipe``) and its parameter shardings come with slices
7b-7d of the port and raise until then.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from bvc_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
# the JAX package's other mesh axes, and the slice of the port that brings each
UNPORTED_AXES = {"model": "7b (tensor parallelism)", "seq": "7c (sequence parallelism)",
                 "pipe": "7d (the pipeline)"}
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
    """The layout of the processes: axis names and sizes (``data`` only)."""

    axis_names: tuple[str, ...]
    shape: dict[str, int]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def refuse_unported_axes(shape: dict[str, int]) -> None:
    """Raise for a mesh axis the port does not run yet, naming its slice."""
    for axis in shape:
        if axis in UNPORTED_AXES:
            raise NotImplementedError(
                f"mesh axis {axis!r} ({shape}): it comes with slice {UNPORTED_AXES[axis]} "
                "of the port; this slice runs a pure data mesh (--mesh data=N)")
        if axis != DATA_AXIS:
            raise ValueError(f"unknown mesh axis {axis!r} in {shape}")


def make_mesh(shape: dict[str, int] | None = None) -> Mesh:
    """The mesh of ``shape`` (e.g. ``{'data': 4}``) over the process group.

    Empty or None puts every rank on ``data``; ``data=-1`` is the world
    size.  ``data`` must equal the world size: ``--mesh data=2`` in one
    process raises rather than running one rank.  A ``model``, ``seq`` or
    ``pipe`` axis raises and names the slice of the port that brings it."""
    shape = dict(shape or {DATA_AXIS: -1})
    refuse_unported_axes(shape)
    world = world_size()
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        raise RuntimeError(f"WORLD_SIZE={os.environ['WORLD_SIZE']} but no process group is "
                           "initialised: call bvc_tpu_torch.parallel.distributed_init() first")
    n = shape[DATA_AXIS]
    if n == -1:
        n = world
    if n != world:
        raise ValueError(
            f"mesh data={n} needs {n} processes, this run has {world}: launch with "
            f"torchrun --nproc_per_node {n} (one process per GPU)")
    return Mesh((DATA_AXIS,), {DATA_AXIS: n})
