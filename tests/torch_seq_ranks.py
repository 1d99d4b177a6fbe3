"""Workers of the sequence-parallel CPU tests (slice 7c), run by
``torch_ranks.run_ranks(fn, spec, tmp, world, module="torch_seq_ranks")``:
each rank joins the gloo group, builds the spec's mesh and returns its
readings.  The workers import only ``torch`` and ``bvc_tpu_torch``."""

from __future__ import annotations

import torch


def _mesh(spec):
    from bvc_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(spec["mesh"])


def mesh_layouts(spec: dict) -> list:
    """``make_mesh`` of each shape of ``spec['shapes']``: this rank's
    coordinates and, for each group of the mesh, its members' global ranks
    (``"world"`` for the world's group)."""
    import torch.distributed as dist

    from bvc_tpu_torch.parallel.mesh import make_mesh

    out = []
    for shape in spec["shapes"]:
        mesh = make_mesh(shape)
        out.append((mesh.coords, {k: "world" if g is None else dist.get_process_group_ranks(g)
                                  for k, g in mesh.groups.items()}))
    return out


def ring(spec: dict) -> dict:
    """``ring_attention`` on this rank's block of each case's q/k/v (and key
    mask), the output block and the gradients of ``sum(o * g)`` w.r.t. this
    rank's q, k and v."""
    from bvc_tpu_torch.ops.attention import multi_head_attention

    mesh = _mesh(spec)
    S, s = mesh.axis_size("seq"), mesh.coord("seq")
    out = {}
    for name, case in spec["cases"].items():
        n = case["q"].shape[1] // S
        blk = slice(s * n, (s + 1) * n)
        q, k, v = (torch.from_numpy(case[x][:, blk]).requires_grad_(True)
                   for x in ("q", "k", "v"))
        mask = None if case.get("mask") is None else torch.from_numpy(case["mask"][:, blk])
        o = multi_head_attention(q, k, v, impl="ring:seq", key_mask=mask)
        (o * torch.from_numpy(case["g"][:, blk])).sum().backward()
        out[name] = {"o": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                     "dv": v.grad.numpy()}
    return out


def _whole_state_dict(state) -> dict:
    return {k: v.detach().clone() for k, v in state.model_state_dict().items()}


def seq_steps(spec: dict) -> dict:
    """For each run of ``spec['runs']`` (``param_sharding``, ``grad_accum``):
    a fresh state from ``spec['weights']``, the seq step (seq x TP on a mesh
    with ``model``) over ``spec['clips']`` (global batches, whole clips:
    each rank takes its data block and time slice) with ``spec['masks']``,
    then the eval step on the first batch with ``spec['eval_mask']``; the
    losses, the metrics, the eval loss and the whole final weights."""
    from bvc_tpu_torch.models.videomae import VideoMAEPretrain
    from bvc_tpu_torch.parallel.seqpar import (make_seq_tp_videomae_train_step,
                                               make_seq_videomae_train_step)
    from bvc_tpu_torch.training.state import TrainState
    from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig

    mesh = _mesh(spec)
    cfg, mask_cfg = ModelConfig(**spec["model"]), MaskConfig(**spec["mask"])
    D, d = mesh.axis_size("data"), mesh.coord("data")
    out = {}
    for mode, accum in spec["runs"]:
        model = VideoMAEPretrain(cfg)
        model.load_state_dict(spec["weights"])
        if "model" in mesh.axis_names:
            state = TrainState.create(model, OptimConfig(**spec["optim"]), device="cpu",
                                      param_sharding="tp")
            step = make_seq_tp_videomae_train_step(cfg, mask_cfg, grad_accum=accum)
        else:
            state = TrainState.create(model, OptimConfig(**spec["optim"]), device="cpu",
                                      param_sharding=mode)
            step = make_seq_videomae_train_step(cfg, mask_cfg, mode, grad_accum=accum)
        frames = step.time_slice

        def local(x):
            b = x.shape[0] // D
            return x[d * b:(d + 1) * b]

        losses, metrics = [], []
        for clips, mask in zip(spec["clips"], spec["masks"]):
            m = step(state, torch.from_numpy(local(clips)[:, frames]),
                     mask=torch.from_numpy(local(mask)))
            losses.append(m["loss"].item())
            metrics.append({k: v.item() for k, v in m.items()})
        ev = step.eval_step(state, torch.from_numpy(local(spec["clips"][0])[:, frames]),
                            mask=torch.from_numpy(local(spec["eval_mask"])))
        out[mode, accum] = {"losses": losses, "metrics": metrics, "eval": ev["loss"].item(),
                            "state_dict": _whole_state_dict(state)}
    return out


def seq_embeds(spec: dict) -> dict:
    """Each family's ``seq_embed`` of ``spec[family]['clips']`` from this
    rank's time slice, with the weights of ``spec[family]['weights']``."""
    from bvc_tpu_torch.models.jepa import JEPAEncoder
    from bvc_tpu_torch.models.videomae import VideoMAEEncoder
    from bvc_tpu_torch.parallel.seqpar import seq_embed, time_slice
    from bvc_tpu_torch.utils.config import ModelConfig

    _mesh(spec)
    out = {}
    for family, cls in (("videomae", VideoMAEEncoder), ("jepa", JEPAEncoder)):
        case = spec[family]
        cfg = ModelConfig(**case["model"])
        enc = cls(cfg)
        enc.load_state_dict(case["weights"])
        clips = torch.from_numpy(case["clips"][:, time_slice(cfg)])
        with torch.no_grad():
            out[family] = seq_embed(enc, clips).numpy()
    return out


def compute_embeddings(spec: dict) -> list:
    """``compute_embeddings.main(spec['argv'])``, the parsed model config in
    ``spec['dtype']`` when given (the CLI builds bf16 models)."""
    from bvc_tpu_torch.cli import compute_embeddings as cli

    if spec.get("dtype"):
        parse = cli.model_config_from_args

        def with_dtype(args):
            cfg = parse(args)
            cfg.dtype = spec["dtype"]
            return cfg

        cli.model_config_from_args = with_dtype
    return cli.main(spec["argv"], device="cpu")


def pretrain_videomae(spec: dict) -> dict:
    """A tiny VideoMAE stage through the CLI's ``main`` (the parsed config
    shrunk by ``torch_tiny_runs``' fixture patch, here applied by hand)."""
    from bvc_tpu_torch.cli import pretrain_videomae as cli
    from torch_tiny_runs import shrink_videomae

    shrink_videomae(cli)
    return cli.main(spec["argv"], device="cpu")
