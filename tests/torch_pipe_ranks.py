"""Workers of the pipeline-parallel CPU tests (slice 7d), run by
``torch_ranks.run_ranks(fn, spec, tmp, world, module="torch_pipe_ranks")``:
each rank joins the gloo group, builds the spec's ``(data, pipe)`` mesh
and returns its readings.  The workers import only ``torch`` and
``bvc_tpu_torch``."""

from __future__ import annotations

import torch


def pipe_steps(spec: dict) -> dict:
    """For each run of ``spec['runs']`` (sampler, ``num_microbatches``,
    ``grad_accum``): a fresh state from ``spec['weights']``, the pipe step
    over ``spec['clips']`` (global batches: each rank takes its data block)
    with the sampler's ``spec['masks']``, then the eval step on the first
    batch with its ``spec['eval_mask']``; the losses, the metrics, the eval
    loss, the whole final weights and optimizer state (as a checkpoint holds
    them), and the parameters the rank holds."""
    from bvc_tpu_torch.models.videomae import VideoMAEPretrain
    from bvc_tpu_torch.parallel.pipeline import make_pipe_mesh, make_pipe_videomae_train_step
    from bvc_tpu_torch.training.checkpoint import optimizer_state_dict
    from bvc_tpu_torch.training.probes import full_grad_probes
    from bvc_tpu_torch.training.state import TrainState
    from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig

    mesh = make_pipe_mesh(spec["data"], spec["pipe"])
    cfg = ModelConfig(**spec["model"])
    D, d = mesh.axis_size("data"), mesh.coord("data")

    def local(x):
        b = x.shape[0] // D
        return torch.from_numpy(x[d * b:(d + 1) * b])

    out = {}
    for sampler, M, accum in spec["runs"]:
        model = VideoMAEPretrain(cfg)
        model.load_state_dict(spec["weights"])
        state = TrainState.create(model, OptimConfig(**spec["optim"]), device="cpu")
        mask_cfg = MaskConfig(sampler=sampler, mask_ratio=spec["mask_ratio"])
        step = make_pipe_videomae_train_step(cfg, mask_cfg, num_microbatches=M,
                                             grad_accum=accum,
                                             grad_probes=full_grad_probes("videomae"))
        held = {n: tuple(p.shape) for n, p in state.model.named_parameters()}
        losses, metrics = [], []
        for clips, mask in zip(spec["clips"], spec["masks"][sampler]):
            m = step(state, local(clips), mask=local(mask))
            losses.append(m["loss"].item())
            metrics.append({k: v.item() for k, v in m.items()})
        ev = step.eval_step(state, local(spec["clips"][0]),
                            mask=local(spec["eval_mask"][sampler]))
        out[sampler, M, accum] = {
            "losses": losses, "metrics": metrics, "eval": ev["loss"].item(),
            "state_dict": state.model_state_dict(), "opt": optimizer_state_dict(state.optimizer),
            "held": held, "coords": dict(mesh.coords), "step": state.step}
    return out


def pretrain_videomae(spec: dict) -> dict:
    """A tiny VideoMAE stage through the CLI's ``main`` (the parsed config
    shrunk by ``torch_tiny_runs``' fixture patch, applied here by hand,
    with ``spec['model']``'s fields on top)."""
    from bvc_tpu_torch.cli import pretrain_videomae as cli
    from torch_tiny_runs import shrink_videomae

    shrink_videomae(cli)
    parse = cli.config_from_args

    def config_from_args(args):
        cfg = parse(args)
        for k, v in spec.get("model", {}).items():
            setattr(cfg.model, k, v)
        return cfg

    cli.config_from_args = config_from_args
    return cli.main(spec["argv"], device="cpu")
