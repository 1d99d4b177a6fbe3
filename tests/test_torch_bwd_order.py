"""The unmasked backward kernel's schedule (``csrc/flash_bwd_sm90.cu``),
emulated on the CPU in torch, against the plain version and against JAX.

The kernel takes one 128-key tile per CTA, split into two 64-key consumer
halves, and walks the queries in 64-row tiles: S^T and dP^T in f32, P^T
rounded to bf16 for dV, dS^T rounded to bf16 for dK and dQ, keys and
queries past N masked to P = 0, dK and dV summed over the query tiles in
f32, and dQ summed over the key tiles in an f32 accumulator by TMA
reductions (adds in L2), one part for each 128-key tile, in an order that
changes from run to run.  The emulation adds those parts in a shuffled order of key tiles to
stand in for that, and is held to
``flash_attention_bwd_ref`` and to JAX's ``_bwd`` (the Pallas ``_dq_kernel``
and ``_dkv_kernel`` in interpret mode, through ``jax.vjp``) at the decoder's
N = 1568 on a few (batch, head) slices, the encoder's N = 160 and an odd
N = 197.

Tolerances: 2e-2 of the largest entry, as ``tests/test_torch_flash_bwd.py``
holds bf16 gradients (the two frameworks round bf16 at other places), and,
against the plain version, 1e-3 in |err|/|ref|, ``chip_smoke.BWD_REL_TOL``.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.ops.flash_attention import flash_attention as jax_flash
from bvc_tpu_torch.ops.flash_attention import (flash_attention_bwd_ref,
                                               flash_attention_fwd_ref)

BF16_TOL = 2e-2  # of max|ref|, tests/test_torch_flash_bwd.py
REL_TOL = 1e-3  # |err|/|ref|, chip_smoke.BWD_REL_TOL
KEY_TILE, HALF, QUERY_TILE = 128, 64, 64
LOG2E = math.log2(math.e)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def emulate(qs, k, v, o, lse, do, key_order, fill=0.0):
    """(dqs, dk, dv) of ``[B, N, h, 64]`` bf16 inputs and ``lse [B, h, N]``
    as the kernel computes them, key tiles taken in ``key_order`` for dQ's
    f32 sum; bf16 outputs.  Rows of the q/dO/K/V tiles past N hold ``fill``
    (TMA fills them with 0; the masks must make their content irrelevant)."""
    B, N, h, d = qs.shape
    n_keys = -(-N // KEY_TILE) * KEY_TILE
    n_pad = -(-N // QUERY_TILE) * QUERY_TILE

    def slices(x, rows):  # [B h, rows, d] f32, rows past N at `fill`
        x = x.float().permute(0, 2, 1, 3).reshape(B * h, N, d)
        return torch.nn.functional.pad(x, (0, 0, 0, rows - N), value=fill)

    q_, do_ = slices(qs, n_pad), slices(do, n_pad)
    k_, v_ = slices(k, n_keys), slices(v, n_keys)
    # the pre-pass: L log2 e and D = rowsum(dO * O) in f32, zeros past N
    l2 = torch.nn.functional.pad(lse.reshape(B * h, N) * LOG2E, (0, n_pad - N))
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * h, N)
    delta = torch.nn.functional.pad(delta, (0, n_pad - N))
    query_ok = torch.arange(n_pad) < N

    dq_acc = torch.zeros(B * h, n_pad, d)
    dk = torch.zeros(B * h, n_keys, d)
    dv = torch.zeros(B * h, n_keys, d)
    for kt in key_order:
        halves = [slice(kt * KEY_TILE + c * HALF, kt * KEY_TILE + (c + 1) * HALF)
                  for c in range(KEY_TILE // HALF)]
        for q0 in range(0, n_pad, QUERY_TILE):
            rows = slice(q0, q0 + QUERY_TILE)
            ds_tile = []
            for keys in halves:  # one consumer warpgroup each
                key_ok = torch.arange(keys.start, keys.stop) < N
                st = k_[:, keys] @ q_[:, rows].transpose(1, 2)  # S^T [64 keys, 64 queries]
                p = torch.exp2(st * LOG2E - l2[:, None, rows])
                p = torch.where(key_ok[:, None] & query_ok[None, rows], p, 0.0)
                dpt = v_[:, keys] @ do_[:, rows].transpose(1, 2)
                ds = bf16(p * (dpt - delta[:, None, rows]))
                dv[:, keys] += bf16(p) @ do_[:, rows]
                dk[:, keys] += ds @ q_[:, rows]
                ds_tile.append(ds)
            # dQ part over the whole key tile (both halves of dS^T), added
            # into the f32 accumulator
            ds_all = torch.cat(ds_tile, dim=1)  # dS^T [128 keys, 64 queries]
            keys = slice(kt * KEY_TILE, (kt + 1) * KEY_TILE)
            dq_acc[:, rows] += ds_all.transpose(1, 2) @ k_[:, keys]

    def out(x):
        return x[:, :N].reshape(B, h, N, d).transpose(1, 2).to(torch.bfloat16)

    return out(dq_acc), out(dk), out(dv)


def inputs(B, N, h, seed):
    """bf16 qs (scaled), k, v and dO from numpy, and the plain forward's O
    and LSE, as the kernel receives them."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, N, h, 64), dtype=np.float32))
                   for _ in range(4))
    qs = (2 * q * 0.125).to(torch.bfloat16)
    k, v = (2 * k).to(torch.bfloat16), (2 * v).to(torch.bfloat16)
    o, lse = flash_attention_fwd_ref(qs, k, v)
    return qs, k, v, o, lse, do.to(torch.bfloat16)


def jax_grads(qs, k, v, do):
    """dqs, dk, dv through JAX's Pallas backward in interpret mode (qs is
    already scaled: scale 1)."""
    args = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (qs, k, v)]
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, scale=1.0, interpret=True), *args)
    grads = vjp(jnp.asarray(do.float().numpy(), jnp.bfloat16))
    return [torch.from_numpy(np.array(g.astype(jnp.float32))) for g in grads]


def shuffled(n_tiles: int, seed: int) -> list[int]:
    order = list(range(n_tiles))
    np.random.default_rng(seed).shuffle(order)
    return order


def close(out, ref, rel_tol=None):
    for name, x, r in zip(("dq", "dk", "dv"), out, ref):
        x, r = x.float(), r.float()
        err = (x - r).abs().max().item()
        assert err <= BF16_TOL * r.abs().max().item(), (name, err)
        if rel_tol is not None:
            rel = ((x - r).norm() / r.norm()).item()
            assert rel <= rel_tol, (name, rel)


@pytest.mark.parametrize("B,N,h", [(1, 1568, 3), (2, 160, 4), (2, 197, 3)],
                         ids=["decoder-1568", "encoder-160", "odd-197"])
def test_schedule_matches_plain_and_jax(B, N, h):
    qs, k, v, o, lse, do = inputs(B, N, h, seed=N)
    got = emulate(qs, k, v, o, lse, do, shuffled(-(-N // KEY_TILE), seed=1))
    close(got, flash_attention_bwd_ref(qs, k, v, o, lse, do), rel_tol=REL_TOL)
    close(got, jax_grads(qs, k, v, do))


@pytest.mark.parametrize("N", [1568, 197])
def test_two_reduce_orders_agree(N):
    # dQ's parts land in the accumulator in another order on every run: two orders
    # give dQ within the tolerance of each other, and dK/dV bit for bit
    qs, k, v, o, lse, do = inputs(1, N, 2, seed=N + 1)
    n_tiles = -(-N // KEY_TILE)
    a = emulate(qs, k, v, o, lse, do, list(range(n_tiles)))
    b = emulate(qs, k, v, o, lse, do, shuffled(n_tiles, seed=7))
    close(a, b, rel_tol=REL_TOL)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


@pytest.mark.parametrize("N", [160, 197])
def test_ragged_edges_add_nothing_past_n(N):
    # N = 160: the second key tile holds 32 real keys and 96 past N, the
    # third query tile 32 real queries; whatever the rows past N hold, the
    # masks (P = 0 for keys and queries past N) keep it out of every output
    qs, k, v, o, lse, do = inputs(1, N, 2, seed=3)
    order = list(range(-(-N // KEY_TILE)))
    zero = emulate(qs, k, v, o, lse, do, order)
    junk = emulate(qs, k, v, o, lse, do, order, fill=300.0)
    assert all(torch.equal(a, b) for a, b in zip(zero, junk))
    close(zero, flash_attention_bwd_ref(qs, k, v, o, lse, do), rel_tol=REL_TOL)
