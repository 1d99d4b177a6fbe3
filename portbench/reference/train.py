"""The reference's first training steps and the readings compared with the
program's.

:func:`follow` runs ``steps`` SGD steps with Nesterov momentum (PyTorch's
form: ``buf = g`` at the first step, ``buf = mu * buf + g`` after, ``p -=
lr * (g + mu * buf)``; no weight decay in these configurations) over the
global batches of the family's :class:`Trainer`, each batch's loss and
gradients summed over blocks of rows so that it fits beside the program's
leftovers, then the family's update after the step (V-JEPA's EMA).

Readings, per leaf of the parameters (and of the EMA target where there is
one): the loss of each step; the norm of the first step's gradient (what
the program's momentum buffer holds after one step); the norm of the
change after the steps (what the step after them finds); the target's
change after them.
"""

from __future__ import annotations

import torch

from portbench.reference import vit


def follow(trainer, params0: dict[str, torch.Tensor], global_batch: int, steps: int,
           rows: int, optim: dict, prec: vit.Precision = vit.F32) -> dict:
    p = {k: v.detach().clone().float().requires_grad_(True) for k, v in params0.items()}
    trainer.start(p)
    target0 = None if trainer.target is None else {k: v.clone()
                                                   for k, v in trainer.target.items()}
    lr, mu = optim["lr"], optim["momentum"]
    buf: dict[str, torch.Tensor] = {}
    out: dict = {"loss": []}
    for s in range(steps):
        inputs = trainer.step_inputs(s, global_batch)
        grads = {k: torch.zeros_like(v) for k, v in p.items()}
        loss = 0.0
        for lo in range(0, global_batch, rows):
            part = trainer.loss_rows(p, inputs, lo, min(lo + rows, global_batch), prec)
            for k, g in zip(p, torch.autograd.grad(part, list(p.values()), allow_unused=True)):
                if g is not None:
                    grads[k] += g
            loss += float(part.detach())
        out["loss"].append(loss)
        if s == 0:
            out["g1"] = {k: float(g.norm()) for k, g in grads.items()}
        with torch.no_grad():
            for k, v in p.items():
                g = grads[k]
                buf[k] = g.clone() if s == 0 else buf[k].mul_(mu).add_(g)
                v.sub_(lr * (g + mu * buf[k]))
        trainer.after_update(p, s)
        del inputs, grads
    out["d3"] = {k: float((v.detach() - params0[k].float()).norm()) for k, v in p.items()}
    if target0 is not None:
        out["t3"] = {k: float((v - target0[k]).norm()) for k, v in trainer.target.items()}
    return out
