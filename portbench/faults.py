"""Faults planted under the timed path, to see ``correct`` come out false
(the control runs and ``portbench/tests/test_portbench_faults.py``; the
benchmark's own runs plant none).

- ``unchanged``: a step that returns its state unchanged;
- ``half_batch``: half of the batch left out, the mean taken over the rest;
- ``no_exchange``: the gradient exchange between cards left out;
- ``altered``: an answer altered where it is produced (one embedding row);
- ``dead_rank``: every rank but 0 fails at its first step (the harness must
  end the run, not wait in a collective).
"""

from __future__ import annotations

import contextlib

import torch


class Fault:
    def batch(self, batch):
        return batch

    def call(self, step, state, batch, *args, **kw):
        return step(state, batch, *args, **kw)

    def wrap_embed(self, fn):
        return fn


class Unchanged(Fault):
    def call(self, step, state, batch, *args, **kw):
        with torch.no_grad():
            kept = [p.detach().clone() for p in state.model.parameters()]
        out = step(state, batch, *args, **kw)
        with torch.no_grad():
            for p, k in zip(state.model.parameters(), kept):
                p.copy_(k)
        return out


class HalfBatch(Fault):
    def batch(self, batch):
        if isinstance(batch, dict):
            return {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return batch[: batch.shape[0] // 2]


class NoExchange(Fault):
    def call(self, step, state, batch, *args, **kw):
        ctx = state.ddp.no_sync() if state.ddp is not None else contextlib.nullcontext()
        with ctx:
            return step(state, batch, *args, **kw)


class Altered(Fault):
    def wrap_embed(self, fn):
        def altered(video):
            out = fn(video).copy()
            out[0] = -out[0]
            return out

        return altered


class DeadRank(Fault):
    def call(self, step, state, batch, *args, **kw):
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_rank() != 0:
            raise RuntimeError("a rank failed")
        return step(state, batch, *args, **kw)


FAULTS = {"unchanged": Unchanged, "half_batch": HalfBatch, "no_exchange": NoExchange,
          "altered": Altered, "dead_rank": DeadRank}
