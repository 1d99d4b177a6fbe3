"""Workers of the communication-accounting CPU tests
(``tests/test_torch_collectives_analysis.py``), run by
``torch_ranks.run_ranks(fn, spec, tmp, world, module="torch_comm_ranks")``:
each rank joins the gloo group, and for each of the spec's runs builds the
run's mesh, a fresh VideoMAE state from the spec's weights and the run's
step, and takes the step's ``comm_report`` on its block of the spec's
clips.  The workers import only ``torch`` and ``bvc_tpu_torch``."""

from __future__ import annotations

import dataclasses

import torch


def fingerprint(state) -> dict:
    """Every tensor a step may change, as this rank holds it (its parts):
    parameters, gradients and buffers of the model and the target, the
    optimizer's (and ZeRO's local optimizer's) state, the step count and
    the generator."""
    from bvc_tpu_torch.parallel.sharding import local_tensor

    out = {"step": state.step, "generator": state.generator.get_state().clone()}
    for name, m in (("model", state.model), ("target", state.target)):
        if m is None:
            continue
        for n, p in m.named_parameters():
            out[f"{name}.{n}"] = local_tensor(p).detach().clone()
            out[f"{name}.{n}.grad"] = (None if p.grad is None
                                       else local_tensor(p.grad).detach().clone())
        for n, b in m.named_buffers():
            out[f"{name}.{n}"] = b.detach().clone()
    for o in (state.optimizer, getattr(state.optimizer, "optim", None)):
        if o is None:
            continue
        for i, st in enumerate(o.state.values()):
            for k, v in st.items():
                out[f"{type(o).__name__}.{i}.{k}"] = (local_tensor(v).clone()
                                                      if torch.is_tensor(v) else v)
        for i, g in enumerate(o.param_groups):
            out[f"{type(o).__name__}.group{i}"] = {k: v for k, v in g.items() if k != "params"}
    return out


def same(a: dict, b: dict) -> bool:
    if a.keys() != b.keys():
        return False
    for k in a:
        x, y = a[k], b[k]
        if torch.is_tensor(x) or torch.is_tensor(y):
            if not (torch.is_tensor(x) and torch.is_tensor(y) and x.dtype == y.dtype
                    and torch.equal(x, y)):
                return False
        elif x != y:
            return False
    return True


def reports(spec: dict) -> dict:
    """For each run ``(name, mesh, kind, param_sharding, grad_accum)`` of
    ``spec['runs']`` (kind ``'step'``, ``'seq'`` or ``'pipe'``): the ops of
    the step's ``comm_report`` on this rank's data block (and time slice) of
    ``spec['clips']``; whether the state was bit-equal before and after it,
    with one real step taken first so that gradients and optimizer state
    exist; the bytes of the parameters the rank holds and of its edge
    parameters (a pipe stage's)."""
    from bvc_tpu_torch.models.videomae import VideoMAEPretrain
    from bvc_tpu_torch.parallel.analysis import tree_bytes
    from bvc_tpu_torch.parallel.mesh import make_mesh
    from bvc_tpu_torch.parallel.pipeline import _stack_layer, make_pipe_videomae_train_step
    from bvc_tpu_torch.parallel.seqpar import make_seq_videomae_train_step
    from bvc_tpu_torch.training.state import TrainState
    from bvc_tpu_torch.training.steps import make_videomae_train_step
    from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig

    out = {}
    for name, shape, kind, mode, accum in spec["runs"]:
        mesh = make_mesh(shape)
        cfg = ModelConfig(**{**spec["model"], **spec.get("overrides", {}).get(name, {})})
        mask_cfg = MaskConfig(**spec["mask"])
        if kind == "seq":
            step = make_seq_videomae_train_step(cfg, mask_cfg, mode, accum, mesh=mesh)
        elif kind == "pipe":
            step = make_pipe_videomae_train_step(cfg, mask_cfg, spec["microbatches"],
                                                 grad_accum=accum, mesh=mesh)
        else:
            step = make_videomae_train_step(cfg, mask_cfg, grad_accum=accum)
        model = VideoMAEPretrain(cfg)
        model.load_state_dict(spec["weights"][name] if name in spec["weights"]
                              else spec["weights"]["default"])
        state = TrainState.create(model, OptimConfig(**spec["optim"]), device="cpu",
                                  param_sharding=mode, mesh=mesh)
        D, d = mesh.axis_size("data"), mesh.coord("data")
        clips = torch.from_numpy(spec["clips"][name] if name in spec["clips"]
                                 else spec["clips"]["default"])
        b = clips.shape[0] // D
        video = clips[d * b:(d + 1) * b][:, getattr(step, "time_slice", slice(None))]
        step(state, video)
        before = fingerprint(state)
        report = step.comm_report(state, video)
        after = fingerprint(state)
        out[name] = {
            "ops": [dataclasses.asdict(op) for op in report.ops],
            "summary": report.summary(), "unchanged": same(before, after),
            "held_bytes": tree_bytes(state.model),
            "edge_bytes": tree_bytes(p for n, p in state.model.named_parameters()
                                     if _stack_layer(n) is None),
            "coords": dict(mesh.coords)}
    return out
