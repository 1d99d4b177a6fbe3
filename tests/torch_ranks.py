"""Run a function of this module (or of another module of ``tests/``, such
as ``test_torch_sharding_ranks``) in ``world`` processes joined by a gloo
process group on the CPU, as torchrun would start them: the rendezvous
variables set, ``bvc_tpu_torch.parallel.distributed_init(device="cpu")``
called, one thread a process.  Each worker writes its result with
``torch.save``; :func:`run_ranks` returns them in rank order.

The workers import only ``torch`` and ``bvc_tpu_torch``.  A failed or hung
worker never leaves its peer behind: the launcher waits with a timeout and
kills the survivors in ``finally`` (the pattern of
``tests/test_multihost.py``).

The worker functions (``videomae_steps``, ``jepa_steps``, ``simclr_steps``,
``extract``, ``compute_embeddings``, ``gather_objects``, ``collectives``,
``mesh_groups``)
take one spec dict, which the test writes with ``torch.save``.
"""

from __future__ import annotations

import copy
import importlib
import os
import socket
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(fn: str, spec: dict, tmp: Path, world: int = 2, timeout: float = 120.0,
              env: dict | None = None, module: str = "torch_ranks") -> list:
    """``fn(spec)`` of ``module`` (a module of ``tests/``, this one by
    default) on each of ``world`` ranks; their results."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    spec_path = tmp / f"{fn}_spec.pt"
    torch.save(spec, spec_path)
    port = _free_port()
    code = ("import sys; sys.path[:0] = [{tests!r}, {repo!r}]; import torch_ranks; "
            "torch_ranks._worker({module!r}, {fn!r}, {spec!r}, {out!r})")
    procs = []
    try:
        for r in range(world):
            worker_env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(world),
                          "LOCAL_RANK": str(r), "MASTER_ADDR": "localhost",
                          "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1",
                          **(env or {})}
            out = tmp / f"{fn}_rank{r}.pt"
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code.format(tests=str(TESTS), repo=str(REPO),
                                                   module=module, fn=fn, spec=str(spec_path),
                                                   out=str(out))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(tmp),
                env=worker_env))
        logs = []
        for p in procs:
            stdout, _ = p.communicate(timeout=timeout)
            logs.append(stdout)
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return [torch.load(tmp / f"{fn}_rank{r}.pt", weights_only=False) for r in range(world)]


def _worker(module: str, fn: str, spec_path: str, out: str) -> None:
    torch.set_num_threads(1)
    from bvc_tpu_torch.parallel import distributed_init

    distributed_init(device="cpu")
    spec = torch.load(spec_path, weights_only=False)
    result = getattr(importlib.import_module(module), fn)(spec)
    torch.save(result, out)
    torch.distributed.destroy_process_group()


def rows(x, world: int, r: int):
    """Rank ``r``'s contiguous block of a global batch (array or dict)."""
    if isinstance(x, dict):
        return {k: rows(v, world, r) for k, v in x.items()}
    b = x.shape[0] // world
    return x[r * b:(r + 1) * b]


# ---------------------------------------------------------------- workers


def _state_result(state, losses: list, metrics: list) -> dict:
    return {"losses": losses, "metrics": metrics,
            "state_dict": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "target": (None if state.target is None else
                       {k: v.clone() for k, v in state.target.state_dict().items()}),
            "step": state.step}


def _counting_hook(seen: list):
    """A DDP comm hook that notes the index of each bucket it all-reduces
    (into the last list of ``seen``)."""
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    def hook(process_group, bucket):
        seen[-1].append(bucket.index())
        return default_hooks.allreduce_hook(process_group, bucket)

    return hook


def train_steps(spec: dict, make_state, make_step, batch_of) -> dict:
    """Run ``spec['batches']`` (global batches) through the step on this
    rank's rows, noting the buckets all-reduced in each step (DDP rebuilds
    its buckets after the first step, so their count may change then)."""
    from bvc_tpu_torch.parallel import rank, world_size

    state = make_state(spec)
    assert state.ddp is not None
    buckets: list[list[int]] = []
    state.ddp.register_comm_hook(None, _counting_hook(buckets))
    step = make_step(spec)
    losses, metrics = [], []
    for batch in spec["batches"]:
        buckets.append([])
        m = step(state, *batch_of(rows(batch, world_size(), rank())))
        losses.append(m["loss"].item())
        metrics.append({k: v.item() for k, v in m.items()})
    result = _state_result(state, losses, metrics)
    result["buckets"] = buckets
    return result


def videomae_steps(spec: dict) -> dict:
    from bvc_tpu_torch.models.videomae import VideoMAEPretrain
    from bvc_tpu_torch.training.state import TrainState
    from bvc_tpu_torch.training.steps import make_videomae_train_step
    from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig

    def make_state(spec):
        model = VideoMAEPretrain(ModelConfig(**spec["model"]))
        model.load_state_dict(spec["weights"])
        return TrainState.create(model, OptimConfig(**spec["optim"]), device="cpu")

    def make_step(spec):
        return make_videomae_train_step(ModelConfig(**spec["model"]), MaskConfig(**spec["mask"]),
                                        grad_accum=spec["grad_accum"])

    return train_steps(spec, make_state, make_step,
                       lambda b: (torch.from_numpy(b["video"]),
                                  None if b.get("mask") is None
                                  else torch.from_numpy(b["mask"])))


def jepa_steps(spec: dict) -> dict:
    from bvc_tpu_torch.models.jepa import JEPA
    from bvc_tpu_torch.training.state import TrainState
    from bvc_tpu_torch.training.steps import make_jepa_train_step
    from bvc_tpu_torch.utils.config import ModelConfig, OptimConfig

    def make_state(spec):
        model = JEPA(ModelConfig(**spec["model"]))
        model.load_state_dict(spec["weights"])
        return TrainState.create(model, OptimConfig(**spec["optim"]), device="cpu",
                                 target=copy.deepcopy(model.encoder))

    def make_step(spec):
        return make_jepa_train_step(ModelConfig(**spec["model"]), spec["total_steps"],
                                    grad_accum=spec["grad_accum"])

    return train_steps(spec, make_state, make_step,
                       lambda b: ({k: torch.from_numpy(v) for k, v in b.items()},))


def simclr_steps(spec: dict) -> dict:
    from bvc_tpu_torch.models.resnet import ResNet
    from bvc_tpu_torch.training.state import TrainState
    from bvc_tpu_torch.training.steps import make_simclr_train_step
    from bvc_tpu_torch.utils.config import OptimConfig

    def make_state(spec):
        model = ResNet(spec["arch"], spec["head"])
        model.load_state_dict(spec["weights"])
        return TrainState.create(model, OptimConfig(**spec["optim"]), device="cpu")

    def make_step(spec):
        return make_simclr_train_step(0.1, negatives=spec["negatives"],
                                      bn_stats=spec["bn_stats"])

    return train_steps(spec, make_state, make_step, lambda b: (torch.from_numpy(b),))


def videomae_stage(spec: dict) -> dict:
    """A tiny VideoMAE stage of 2 epochs at 4 clips a rank under
    ``root/straight``, and the same stage stopped after epoch 1 and resumed
    under ``root/resumed``; the two summaries."""
    from bvc_tpu_torch.training.trainer_videomae import run_pretraining
    from bvc_tpu_torch.utils.config import TrainConfig
    from torch_tiny_runs import tiny_cfg

    root, rid = Path(spec["root"]), "dev_1_g0_default_0_0"

    def cfg(folder, n_epoch, resume=False):
        return tiny_cfg(TrainConfig, "videomae", spec["corpus"], root / folder, rid,
                        batch_size=4, n_epoch=n_epoch, resume=resume)

    straight = run_pretraining(cfg("straight", 2), device="cpu")
    run_pretraining(cfg("resumed", 1), device="cpu")
    resumed = run_pretraining(cfg("resumed", 2, resume=True), device="cpu")
    return {"straight": straight["train_loss"], "resumed": resumed["train_loss"]}


def collectives(spec: dict) -> dict:
    """Each collective once on every rank, rank 1 holding an empty list and
    zero rows."""
    import numpy as np

    from bvc_tpu_torch.evalbench.extract import merge_gathered
    from bvc_tpu_torch.parallel import (all_gather_grad, all_gather_objects, all_reduce_grad,
                                        psum_scalar, rank, sync_hosts, world_size)

    r = rank()
    local = ({"fnames": ["a", "b", "c"], "embeddings": np.ones((3, 4), np.float32)} if r == 0
             else {"fnames": [], "embeddings": np.zeros((0, 4), np.float32)})
    gathered = all_gather_objects(local)
    names, rows_ = merge_gathered(gathered)
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    g = all_gather_grad(x)
    weights = torch.arange(12.0).reshape(4, 3)
    (g * weights).sum().backward()  # the same loss on every rank
    y = torch.tensor([1.0 + r], requires_grad=True)
    s = all_reduce_grad(y * 2)
    (s * (r + 1)).backward()
    sync_hosts()
    return {"world": world_size(), "gathered": gathered, "names": names, "rows": rows_,
            "g": g.detach(), "x_grad": x.grad, "s": s.detach(), "y_grad": y.grad,
            "mean": psum_scalar(torch.tensor(float(r))).item()}


def mesh_groups(spec: dict) -> list:
    """``make_mesh`` of each shape of ``spec['shapes']`` in turn; for each,
    the process groups it created, whether it returned the mesh before it,
    and the mesh's shape and this rank's coordinates."""
    import torch.distributed as dist

    from bvc_tpu_torch.parallel import make_mesh

    created: list[int] = []
    new_group = dist.new_group

    def counting(*args, **kwargs):
        created[-1] += 1
        return new_group(*args, **kwargs)

    dist.new_group = counting
    out, last = [], None
    for shape in spec["shapes"]:
        created.append(0)
        mesh = make_mesh(shape)
        out.append((created[-1], mesh is last, mesh.shape, mesh.coords))
        last = mesh
    return out


class OddClips:
    """11 clips of ``[2, 32, 32, 3]`` from seeds, clip 5 unreadable (the
    readers' ``(None, None)``)."""

    def __len__(self) -> int:
        return 11

    def __getitem__(self, i: int):
        import numpy as np

        if i == 5:
            return None, None
        clip = np.random.default_rng(i).normal(size=(2, 32, 32, 3)).astype(np.float32)
        return clip, f"clip_{i:02d}"


def simclr_embed_fn(calls: list):
    """Untrained ResNet-18 extraction on the CPU, counting its calls."""
    from bvc_tpu_torch.evalbench.extract import untrained_embed_fn
    from bvc_tpu_torch.utils.config import ModelConfig

    fn = untrained_embed_fn("simclr", ModelConfig(architecture="resnet18", image_size=32,
                                                  num_frames=2), device="cpu")

    def counted(clips):
        calls.append(len(clips))
        return fn(clips)

    counted.feature_dim = fn.feature_dim
    return counted


def extract(spec: dict) -> dict:
    from bvc_tpu_torch.evalbench.extract import extract_embeddings

    calls: list[int] = []
    names, embs = extract_embeddings(simclr_embed_fn(calls), OddClips(), spec["batch_size"],
                                     num_workers=1)
    return {"names": names, "embs": embs, "calls": calls}


def compute_embeddings(spec: dict) -> list:
    from bvc_tpu_torch.cli import compute_embeddings as cli

    return cli.main(spec["argv"], device="cpu")
