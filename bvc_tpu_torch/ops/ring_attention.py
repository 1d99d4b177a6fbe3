"""Ring attention over a sequence split across the ranks of a ``seq`` ring
(counterpart of :mod:`bvc_tpu.ops.ring_attention`).

Each rank holds one contiguous block of the global sequence, ``[B, n, h,
d]`` q/k/v with ``n = N / S``.  The K/V blocks travel around the ring (S
hops, a shift to the next rank after each), and every hop attends the
rank's queries to the block it holds.  The JAX ring writes each hop's
attention out in ``jnp``, for any dtype and head width.  Here the route of
a ring is decided once, before its first hop, by
:func:`~bvc_tpu_torch.ops.flash_attention.kernel_route`: the rule of one-card
attention apart from its token thresholds, since a hop's block may be of
any length:

- **flash**, for CUDA bf16 blocks at a width the kernels take (64; 64 or
  32 with a key mask): every hop runs the flash kernels through their
  custom operators (:mod:`bvc_tpu_torch.ops.flash_attention`).  A kernel
  that fails to build or launch raises; nothing falls back.
- **plain**, for anything else (f32, other head widths, CPU tensors):
  every hop computes its O and f32 LSE in plain torch, with the JAX ring's
  ``_block_update`` math (f32 scores, f32 probabilities, f32 P.V), and its
  backward from the same global O and LSE (:func:`plain_hop_fwd`,
  :func:`plain_hop_bwd`).  The merge, the transport and the all-masked
  rows' conventions are the same on both routes.

- **Forward**: ``qs = q * scale`` once; each hop calls
  ``torch.ops.bvc_tpu_torch.flash_fwd(qs, k_blk, v_blk, bias_blk)`` (or
  the plain hop), which returns the hop's O and LSE, and merges them into
  f32 accumulators, ``lse' = logaddexp(lse, lse_h)``, ``o' = o exp(lse -
  lse') + o_h exp(lse_h - lse')``.  A hop in which a row's keys are all masked (the kernel's LSE
  = +inf) gets weight 0; a row whose keys are masked in every hop gets the
  mean of the hops' outputs, uniform weights over every global key, as the
  JAX ring gives, and LSE = +inf.
- **Backward**: each hop calls ``flash_bwd(qs, k_blk, v_blk, o, lse, do,
  bias_blk)`` with the **global** O and LSE, so the kernel's P is the
  global probability of the block's keys; dQs adds into an f32 sum, dK and
  dV into f32 buffers that travel with their block, and one more shift
  after the last hop brings each block's dK and dV home.  dQ is the f32 sum
  of the hops' bf16 dQs (the backward's post-pass rounds each hop's f32
  accumulator to bf16), times the scale.  A row with LSE = +inf gets no
  gradient, as the flash path gives it.
- **Overlap**: the next hop's K/V shift is started before the hop's kernel
  and waited for after it (NCCL runs it beside the kernel); the dK/dV
  shift follows the hop's kernel, which makes them.

The transport is a :class:`Ring`: :class:`GroupRing` shifts over a
process group (:func:`~bvc_tpu_torch.parallel.collectives.ring_shift`),
:class:`ChunkRing` holds all S blocks of a sequence in one process, stacked
on the batch axis, and shifts them by a roll; each hop is then one launch
over the S query blocks (:func:`ring_attention_chunks`).
"""

from __future__ import annotations

import math

import torch

from bvc_tpu_torch.ops.flash_attention import (flash_attention_bwd_ref, flash_attention_fwd_ref,
                                               flash_bwd, flash_fwd, kernel_route, resolve_bias)
from bvc_tpu_torch.parallel.collectives import ring_shift_start


def plain_hop_fwd(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """One hop of the plain route: ``(o [B, n, h, d], lse [B, h, n])`` in
    f32, from f32 scores and probabilities and an f32 P.V (the JAX ring's
    ``_block_update``), with the kernels' +inf LSE on a row whose keys in
    the hop are all masked."""
    return flash_attention_fwd_ref(qs.float(), k.float(), v.float(), bias)


def plain_hop_bwd(qs, k, v, o, lse, do, bias) -> tuple[torch.Tensor, ...]:
    """One hop's ``(dqs, dk, dv)`` in f32 on the plain route, from the
    global ``o`` and ``lse``."""
    return flash_attention_bwd_ref(qs.float(), k.float(), v.float(), o.float(), lse,
                                   do.float(), bias)


HOPS = {"flash": (flash_fwd, flash_bwd), "xla": (plain_hop_fwd, plain_hop_bwd)}


class Ring:
    """A ring of ``size`` blocks: :meth:`start` sends each held block to
    the next member and returns a handle whose ``wait()`` gives the
    previous member's."""

    size: int = 1

    def start(self, tensors: list[torch.Tensor]):
        raise NotImplementedError

    def shift(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        return self.start(tensors).wait()


class _Done:
    def __init__(self, tensors: list[torch.Tensor]):
        self.tensors = tensors

    def wait(self) -> list[torch.Tensor]:
        return self.tensors


class GroupRing(Ring):
    """The ranks of a process group (a ``seq`` ring; None: the world), one
    block a rank."""

    def __init__(self, group, size: int):
        self.group, self.size = group, size

    def start(self, tensors):
        if self.size == 1:
            return _Done(tensors)
        return ring_shift_start(tensors, self.group)


class ChunkRing(Ring):
    """``size`` blocks in one process, stacked on dim 0 (``size`` groups of
    ``rows`` rows): block ``r`` moves to ``r + 1`` (a roll by ``rows``)."""

    def __init__(self, size: int, rows: int):
        self.size, self.rows = size, rows

    def start(self, tensors):
        return _Done([torch.roll(t, self.rows, dims=0) for t in tensors])


def _held(*tensors: torch.Tensor | None) -> list[torch.Tensor]:
    return [t for t in tensors if t is not None]


def merge_hop(o_acc: torch.Tensor, lse_acc: torch.Tensor, o_h: torch.Tensor,
              lse_h: torch.Tensor, hop: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 accumulators ``(o [B, n, h, d], lse [B, h, n])`` after merging
    hop ``hop``'s ``(o_h, lse_h)`` (the kernel's: LSE +inf where the hop has
    no attendable key, which gets weight 0); ``lse`` stays -inf on a row
    with no key in any hop so far, whose ``o`` is the mean of the hops'."""
    lse_h = lse_h.masked_fill(lse_h == math.inf, -math.inf)
    new = torch.logaddexp(lse_acc, lse_h)
    seen = new > -math.inf
    a = torch.where(seen, torch.exp(lse_acc - new), hop / (hop + 1.0))
    b = torch.where(seen, torch.exp(lse_h - new), 1.0 / (hop + 1.0))
    o = o_acc * a.transpose(1, 2)[..., None] + o_h.float() * b.transpose(1, 2)[..., None]
    return o, new


def ring_fwd(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor | None,
             ring: Ring, route: str = "flash") -> tuple[torch.Tensor, torch.Tensor]:
    """The merged ``(o, lse)`` of the held queries ``qs`` (pre-scaled)
    against every block of the ring, each hop on ``route``: ``o`` ``[B, n,
    h, d]`` in ``qs``'s dtype, ``lse`` ``[B, h, n]`` f32 (+inf on a row with
    no attendable key anywhere)."""
    hop_fwd = HOPS[route][0]
    if ring.size == 1:  # one hop: its own O and LSE, nothing to merge
        o, lse = hop_fwd(qs, k, v, bias)
        return o.to(qs.dtype), lse
    B, n, h, d = qs.shape
    o_acc = torch.zeros((B, n, h, d), dtype=torch.float32, device=qs.device)
    lse_acc = torch.full((B, h, n), -math.inf, dtype=torch.float32, device=qs.device)
    k_blk, v_blk, b_blk = k, v, bias
    for hop in range(ring.size):
        pending = ring.start(_held(k_blk, v_blk, b_blk)) if hop < ring.size - 1 else None
        o_acc, lse_acc = merge_hop(o_acc, lse_acc, *hop_fwd(qs, k_blk, v_blk, b_blk), hop)
        if pending is not None:
            k_blk, v_blk, *rest = pending.wait()
            b_blk = rest[0] if rest else None
    lse = lse_acc.masked_fill(lse_acc == -math.inf, math.inf)
    return o_acc.to(qs.dtype), lse


def ring_bwd(qs, k, v, o, lse, do, bias, ring: Ring, route: str = "flash"
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dqs, dk, dv)`` of the held blocks (f32 sums over the hops; the
    hop's own outputs on a ring of one), from the global ``o`` and ``lse``
    of :func:`ring_fwd` and the output gradient ``do``, each hop on
    ``route``."""
    hop_bwd = HOPS[route][1]
    if ring.size == 1:
        return hop_bwd(qs, k, v, o, lse, do, bias)
    f32 = {"dtype": torch.float32, "device": qs.device}
    dq = torch.zeros(qs.shape, **f32)
    dk, dv = torch.zeros(k.shape, **f32), torch.zeros(v.shape, **f32)
    k_blk, v_blk, b_blk = k, v, bias
    for hop in range(ring.size):
        pending = ring.start(_held(k_blk, v_blk, b_blk)) if hop < ring.size - 1 else None
        dq_h, dk_h, dv_h = hop_bwd(qs, k_blk, v_blk, o, lse, do, b_blk)
        dq += dq_h.float()
        dk += dk_h.float()
        dv += dv_h.float()
        dk, dv = ring.shift([dk, dv])  # with their block; after the last hop, home
        if pending is not None:
            k_blk, v_blk, *rest = pending.wait()
            b_blk = rest[0] if rest else None
    return dq, dk, dv


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale, ring):
        qs = (q * scale).to(q.dtype)
        route = kernel_route(q.device.type, q.dtype, q.shape[-1], bias is not None)
        o, lse = ring_fwd(qs, k, v, bias, ring, route)
        ctx.save_for_backward(qs, k, v, o, lse, bias)
        ctx.scale, ctx.ring, ctx.route = scale, ring, route
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qs, k, v, o, lse, bias = ctx.saved_tensors
        dq, dk, dv = ring_bwd(qs, k, v, o, lse, do.contiguous(), bias, ctx.ring, ctx.route)
        return ((dq * ctx.scale).to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None)


def _bias(key_mask, bias, device) -> torch.Tensor | None:
    bias = resolve_bias(key_mask, bias)
    return None if bias is None else bias.to(device, torch.float32).contiguous()


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group, size: int,
                   scale: float | None = None, key_mask: torch.Tensor | None = None,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Exact attention of this rank's block ``[B, n, h, d]`` of a sequence
    split over the ``size`` ranks of ``group`` (a ``seq`` ring; None: the
    world) against the whole sequence; differentiable in q, k, v.

    ``key_mask`` (``[B, n]`` bool, True = attendable) masks this rank's
    keys and travels with its block; or ``bias``, that mask's f32 key bias
    already built.  Returns this rank's output block in q's dtype.  Every
    rank of the ring calls it with blocks of one shape."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RingAttention.apply(q, k, v, _bias(key_mask, bias, q.device), scale,
                                GroupRing(group, size))[0]


def _stack_chunks(x: torch.Tensor, S: int) -> torch.Tensor:
    """``[B, N, ...]`` -> ``[S * B, N / S, ...]``, chunk-major."""
    B, N = x.shape[:2]
    return x.reshape(B, S, N // S, *x.shape[2:]).transpose(0, 1).reshape(
        S * B, N // S, *x.shape[2:])


def _unstack_chunks(x: torch.Tensor, S: int) -> torch.Tensor:
    B = x.shape[0] // S
    return x.reshape(S, B, *x.shape[1:]).transpose(0, 1).reshape(
        B, S * x.shape[1], *x.shape[2:])


def ring_attention_chunks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, S: int,
                          scale: float | None = None, key_mask: torch.Tensor | None = None,
                          bias: torch.Tensor | None = None, return_lse: bool = False):
    """The ring's hop math and merge over ``S`` contiguous chunks of one
    ``[B, N, h, d]`` sequence in one process, with no transport: the
    chunks are stacked on the batch axis (:class:`ChunkRing`), so each hop
    is one forward launch (one of each backward kernel) for all S query
    chunks.  Differentiable in q, k, v; ``return_lse`` also returns the
    merged ``[B, h, N]`` LSE (no gradient).  ``N`` must divide by ``S``."""
    B, N = q.shape[:2]
    if N % S:
        raise ValueError(f"{N} tokens do not split into {S} ring chunks")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    bias = _bias(key_mask, bias, q.device)
    q_s, k_s, v_s = (_stack_chunks(x, S) for x in (q, k, v))
    b_s = None if bias is None else _stack_chunks(bias, S).contiguous()
    o, lse = _RingAttention.apply(q_s, k_s, v_s, b_s, scale, ChunkRing(S, B))
    o = _unstack_chunks(o, S)
    if not return_lse:
        return o
    return o, _unstack_chunks(lse.transpose(1, 2), S).transpose(1, 2)
