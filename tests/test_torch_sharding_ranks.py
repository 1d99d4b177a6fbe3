"""Rank workers of the sharded-training tests (no tests of its own), run in
``world`` processes joined by a gloo group on the CPU by
``tests/torch_ranks.py``'s launcher: ``run_ranks(fn, spec, tmp, world,
module="test_torch_sharding_ranks")``.

The workers import only ``torch`` and ``bvc_tpu_torch``; each takes one
spec dict and returns its result, which ``run_ranks`` hands back in rank
order:

- :func:`steps`: a family's training steps under a ``--param_sharding``
  mode on a ``data`` x ``model`` mesh, each rank on its data coordinate's
  rows, with the grad-stats probes; the losses, every metric, the whole
  weights (and target) after the steps, the optimizer state as a
  checkpoint holds it, and what the layout looks like on the rank;
- :func:`stage`: a trainer stage (``run_pretraining``) under a mode;
- :func:`cli`: a pretraining CLI's ``main`` under a mode.
"""

from __future__ import annotations

import copy

import torch

from torch_ranks import rows

# ---------------------------------------------------------------- workers


def new_state(spec: dict, param_sharding: str):
    """The family's state of ``spec`` under ``param_sharding`` on the CPU,
    from ``spec['weights']`` (JEPA's target a copy of its encoder)."""
    from bvc_tpu_torch.models.jepa import JEPA
    from bvc_tpu_torch.models.resnet import ResNet
    from bvc_tpu_torch.models.videomae import VideoMAEPretrain
    from bvc_tpu_torch.training.state import TrainState
    from bvc_tpu_torch.utils.config import ModelConfig, OptimConfig

    family, target = spec["family"], None
    if family == "videomae":
        model = VideoMAEPretrain(ModelConfig(**spec["model"]))
    elif family == "jepa":
        model = JEPA(ModelConfig(**spec["model"]))
    else:
        model = ResNet(spec["arch"], spec["head"])
    model.load_state_dict(spec["weights"])
    if family == "jepa":
        target = copy.deepcopy(model.encoder)
    return TrainState.create(model, OptimConfig(**spec["optim"]), device="cpu",
                             target=target, param_sharding=param_sharding)


def new_step(spec: dict):
    """The family's step of ``spec``, with the family's grad-stats probes."""
    from bvc_tpu_torch.training.probes import full_grad_probes
    from bvc_tpu_torch.training.steps import (make_jepa_train_step, make_simclr_train_step,
                                              make_videomae_train_step)
    from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig

    family = spec["family"]
    probes = full_grad_probes(family)
    if family == "videomae":
        return make_videomae_train_step(ModelConfig(**spec["model"]), MaskConfig(**spec["mask"]),
                                        grad_accum=spec["grad_accum"], grad_probes=probes)
    if family == "jepa":
        return make_jepa_train_step(ModelConfig(**spec["model"]), spec["total_steps"],
                                    grad_accum=spec["grad_accum"], grad_probes=probes)
    return make_simclr_train_step(0.1, grad_probes=probes)


def step_args(family: str, batch) -> tuple:
    if family == "videomae":
        return (torch.from_numpy(batch["video"]), torch.from_numpy(batch["mask"]))
    if family == "jepa":
        return ({k: torch.from_numpy(v) for k, v in batch.items()},)
    return (torch.from_numpy(batch),)


def layout(state) -> dict:
    """What the rank holds: each parameter's kind (``dtensor``, ``tp`` or
    ``whole``) and local shape, the first encoder block's ``qkv`` parts,
    each block's FSDP wrapping."""
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor

    from bvc_tpu_torch.models.vit import Block
    from bvc_tpu_torch.parallel.sharding import local_tensor

    def kind(p):
        return "dtensor" if isinstance(p, DTensor) else (
            "tp" if hasattr(p, "tp_split") else "whole")

    out = {"params": {n: (kind(p), tuple(local_tensor(p).shape))
                      for n, p in state.model.named_parameters()},
           "blocks_fsdp": [isinstance(m, FSDPModule) for m in state.model.modules()
                           if isinstance(m, Block)],
           "root_fsdp": isinstance(state.model, FSDPModule), "ddp": state.ddp is not None}
    enc = getattr(state.model, "encoder", None)
    if enc is not None:
        qkv = enc.blocks.layers[0].qkv
        out["qkv"] = (local_tensor(qkv.weight).detach().clone(),
                      local_tensor(qkv.bias).detach().clone())
    return out


def steps(spec: dict) -> dict:
    """``spec['batches']`` (global batches) through the family's step under
    ``spec['mode']`` on ``spec['mesh']``, this rank on its data
    coordinate's rows; the layout before the first step, the losses, the
    metrics, the whole weights (and target) and the optimizer state after
    the last, with the names of the parameters whose optimizer state the
    rank keeps (ZeRO: its partition) under ``layout['opt_state']``."""
    from bvc_tpu_torch.parallel import data_rank, data_size, make_mesh
    from bvc_tpu_torch.training.checkpoint import optimizer_state_dict

    make_mesh(spec["mesh"])
    state = new_state(spec, spec["mode"])
    before = layout(state)
    step = new_step(spec)
    losses, metrics = [], []
    for batch in spec["batches"]:
        m = step(state, *step_args(spec["family"], rows(batch, data_size(), data_rank())))
        losses.append(m["loss"].item())
        metrics.append({k: v.item() for k, v in m.items()})
    opt = getattr(state.optimizer, "optim", state.optimizer)  # ZeRO's local optimizer
    names = {id(p): n for n, p in state.model.named_parameters()}
    before["opt_state"] = sorted(names[id(p)] for p in opt.state)
    return {"losses": losses, "metrics": metrics, "layout": before,
            "state_dict": state.model_state_dict(),
            "target": None if state.target is None else state.target_state_dict(),
            "opt": optimizer_state_dict(state.optimizer), "step": state.step}


def stage(spec: dict) -> dict:
    """A tiny trainer stage of ``spec['family']`` under ``spec['mode']`` on
    ``spec['mesh']`` (``tests/torch_tiny_runs.py``'s config, ``spec['cfg']``
    fields on top); its summary."""
    from bvc_tpu_torch.training import trainer_jepa, trainer_simclr, trainer_videomae
    from bvc_tpu_torch.utils.config import TrainConfig
    from torch_tiny_runs import tiny_cfg

    cfg = tiny_cfg(TrainConfig, spec["family"], spec["corpus"], spec["savedir"],
                   spec["run_id"], batch_size=spec["batch_size"], **spec.get("cfg", {}))
    cfg.mesh_shape, cfg.param_sharding = spec["mesh"], spec["mode"]
    trainer = {"videomae": trainer_videomae, "jepa": trainer_jepa,
               "simclr": trainer_simclr}[spec["family"]]
    return trainer.run_pretraining(cfg, device="cpu")


def cli(spec: dict) -> dict:
    """``main(spec['argv'], device='cpu')`` of the family's pretraining CLI,
    with ``spec['model']``'s fields set on the parsed model config (the
    VideoMAE CLI has no width flags)."""
    from bvc_tpu_torch.cli import pretrain_jepa, pretrain_simclr, pretrain_videomae

    module = {"videomae": pretrain_videomae, "jepa": pretrain_jepa,
              "simclr": pretrain_simclr}[spec["family"]]
    with_model_fields(module, spec["model"])
    return module.main(spec["argv"], device="cpu")


def with_model_fields(module, fields: dict) -> None:
    """Make CLI ``module``'s ``config_from_args`` set ``fields`` on the
    model config it parses."""
    parse = module.config_from_args

    def config_from_args(args):
        cfg = parse(args)
        for k, v in fields.items():
            setattr(cfg.model, k, v)
        return cfg

    module.config_from_args = config_from_args
