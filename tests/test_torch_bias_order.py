"""The key-bias kernels' schedules (``csrc/flash_fwd.cu`` ``flash_fwd_bias_sm90``
and ``csrc/flash_bwd_sm90.cu`` ``flash_bwd_sm90<d, true>``), emulated on the
CPU in torch, against the plain versions and against JAX.

The forward takes 128-key tiles, last first, and skips every tile whose keys
are all masked, except for a batch element with no attendable key, which
takes every tile so that its rows stay uniform over its N keys (LSE = +inf).
Its softmax runs in base 2 on s = S log2 e + bias log2 e, from a running
max of -inf, with the biases of keys past N at -inf, not -1e30.  Its query
tiles are 192 rows at d = 64 and 128 at d = 32, rows past N computed on
whatever the tiles hold and never stored.  The backward takes one 128-key
tile per CTA; a tile whose keys are all masked writes zero dK and dV and
adds nothing to dQ; the others walk 64-query tiles in two 64-key halves with
P^T = exp2(S^T log2 e + (bias - L) log2 e), and dQ's parts are added over
the key tiles in an order that changes from run to run (shuffled here).

The emulation is held to ``flash_attention_fwd_ref`` /
``flash_attention_bwd_ref`` and to JAX's Pallas ``_fwd_kernel_bias``,
``_dq_kernel_bias`` and ``_dkv_kernel_bias`` in interpret mode (through
``flash_attention(..., key_mask=)`` and ``jax.vjp``) at N = 169, 197 and 199
with the JEPA collator's masks and random ones, at d = 64 and 32.

Tolerances, as ``tests/test_torch_flash_bias.py``: forward 1e-5 and
gradients 1e-4, absolute and relative, in f32 (P is rounded to the value
dtype, as the kernels do, which at f32 is no rounding); masked keys' dK and
dV exactly 0.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.ops.flash_attention import flash_attention as jax_flash
from bvc_tpu_torch.masks.multiblock import mask_collate
from bvc_tpu_torch.ops.flash_attention import (NEG_INF, flash_attention_bwd_ref,
                                               flash_attention_fwd_ref, key_bias)
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig

TOL = 1e-5  # forward, tests/test_torch_flash_bias.py
GRAD_TOL = 1e-4  # gradients, the same
KEY_TILE, HALF, QUERY_TILE = 128, 64, 64
LOG2E = math.log2(math.e)
LN2 = math.log(2.0)
# -1e30 log2 e in f32, the base-2 score of a masked key
NEG_LOG2 = (torch.tensor(NEG_INF, dtype=torch.float32) * LOG2E).item()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def n_tiles(N: int) -> int:
    return -(-N // KEY_TILE)


def live_tiles(bias: torch.Tensor) -> list[list[int]]:
    """Per batch element, the key tiles the kernels take, last first: those
    with a key that may be attended, or every tile where none may be."""
    B, N = bias.shape
    out = []
    for b in range(B):
        tiles = [t for t in range(n_tiles(N))
                 if bool((bias[b, t * KEY_TILE:(t + 1) * KEY_TILE] > NEG_INF).any())]
        out.append(sorted(tiles or range(n_tiles(N)), reverse=True))
    return out


def pad_rows(x: torch.Tensor, rows: int, fill: float) -> torch.Tensor:
    """``[N, h, d]`` as ``[h, rows, d]`` f32, rows past N at ``fill``."""
    x = x.float().transpose(0, 1)
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[1]), value=fill)


def emulate_fwd(qs, k, v, bias, fill=0.0, skip=True, pad_bias=-math.inf):
    """(o, lse) as ``flash_fwd_bias_sm90`` computes them.  ``skip=False``
    takes every key tile; ``pad_bias`` is the bias of keys past N (the
    kernel's -inf; -1e30 shows what it guards against)."""
    B, N, h, d = qs.shape
    q_rows = 192 if d == 64 else 128
    rows = -(-N // q_rows) * q_rows
    keys = n_tiles(N) * KEY_TILE
    b2 = torch.nn.functional.pad(bias * LOG2E, (0, keys - N), value=pad_bias * LOG2E)
    tiles = live_tiles(bias) if skip else [list(range(n_tiles(N)))[::-1]] * B
    o = torch.empty(B, N, h, d)
    lse = torch.empty(B, h, N)
    for b in range(B):
        q_, k_, v_ = pad_rows(qs[b], rows, fill), pad_rows(k[b], keys, fill), pad_rows(
            v[b], keys, fill)
        m = torch.full((h, rows), -math.inf)
        l = torch.zeros(h, rows)
        acc = torch.zeros(h, rows, d)
        for t in tiles[b]:
            cols = slice(t * KEY_TILE, (t + 1) * KEY_TILE)
            s = (q_ @ k_[:, cols].transpose(1, 2)) * LOG2E + b2[b, cols]
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.to(v.dtype).float() @ v_[:, cols]
            m = mx
        o[b] = (acc / l[..., None])[:, :N].transpose(0, 1)
        lse[b] = torch.where(m <= NEG_LOG2, math.inf, m * LN2 + torch.log(l))[:, :N]
    return o.to(qs.dtype), lse


def emulate_bwd(qs, k, v, o, lse, do, bias, key_order, fill=0.0):
    """(dqs, dk, dv) as the three backward kernels compute them, dQ's parts
    added over the key tiles in ``key_order``; rows of the tiles past N hold
    ``fill``."""
    B, N, h, d = qs.shape
    keys = n_tiles(N) * KEY_TILE
    n_pad = -(-N // QUERY_TILE) * QUERY_TILE
    query_ok = torch.arange(n_pad) < N
    dq, dk, dv = (torch.empty(B, N, h, d) for _ in range(3))
    for b in range(B):
        q_, do_ = pad_rows(qs[b], n_pad, fill), pad_rows(do[b], n_pad, fill)
        k_, v_ = pad_rows(k[b], keys, fill), pad_rows(v[b], keys, fill)
        # the pre-pass: L log2 e (+inf stays +inf) and D, zeros past N
        l2 = torch.nn.functional.pad(lse[b] * LOG2E, (0, n_pad - N))
        delta = (do[b].float() * o[b].float()).sum(-1).transpose(0, 1)
        delta = torch.nn.functional.pad(delta, (0, n_pad - N))
        b2 = torch.nn.functional.pad(bias[b] * LOG2E, (0, keys - N))
        dq_acc = torch.zeros(h, n_pad, d)
        dk_, dv_ = torch.zeros(h, keys, d), torch.zeros(h, keys, d)
        for kt in key_order:
            tile = slice(kt * KEY_TILE, (kt + 1) * KEY_TILE)
            if not bool((bias[b, tile] > NEG_INF).any()):
                continue  # a dead CTA: zero dK and dV rows, nothing into dQ
            for q0 in range(0, n_pad, QUERY_TILE):
                rows = slice(q0, q0 + QUERY_TILE)
                ds_tile = []
                for c in range(KEY_TILE // HALF):  # one consumer warpgroup each
                    half = slice(kt * KEY_TILE + c * HALF, kt * KEY_TILE + (c + 1) * HALF)
                    key_ok = torch.arange(half.start, half.stop) < N
                    st = k_[:, half] @ q_[:, rows].transpose(1, 2)  # S^T [64 keys, 64 queries]
                    p = torch.exp2(st * LOG2E + (b2[half][:, None] - l2[:, None, rows]))
                    p = torch.where(key_ok[:, None] & query_ok[None, rows], p, 0.0)
                    dpt = v_[:, half] @ do_[:, rows].transpose(1, 2)
                    ds = (p * (dpt - delta[:, None, rows])).to(qs.dtype).float()
                    dv_[:, half] += p.to(v.dtype).float() @ do_[:, rows]
                    dk_[:, half] += ds @ q_[:, rows]
                    ds_tile.append(ds)
                dq_acc[:, rows] += torch.cat(ds_tile, dim=1).transpose(1, 2) @ k_[:, tile]
        for out, x in ((dq, dq_acc), (dk, dk_), (dv, dv_)):
            out[b] = x[:, :N].transpose(0, 1)
    return dq.to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype)


def collator_masks(B: int) -> tuple[np.ndarray, np.ndarray]:
    """The JEPA collator's context ``[B, 169]`` and predictor ``[4 B, 199]``
    key masks, as the modules build them, from the CLI defaults' caps."""
    cfg = ModelConfig(family="jepa", num_frames=2, tubelet_size=1)
    mcfg = MaskConfig(enc_mask_scale=(0.85, 1.0), pred_mask_scale=(0.1, 0.15))
    batch = mask_collate(cfg, mcfg, seed=0)(B, step=0)
    enc = batch["enc_idx"] >= 0
    pred = batch["pred_idx"] >= 0  # [B, M, Kp]
    M = pred.shape[1]
    tiled = np.broadcast_to(enc[None], (M,) + enc.shape).reshape(M * B, -1)
    return enc, np.concatenate([tiled, pred.transpose(1, 0, 2).reshape(M * B, -1)], axis=1)


def inputs(N: int, d: int, kind: str, seed: int):
    """f32 qs (scaled), k, v, dO and a bool key mask ``[2, N]``: the
    collator's (N = 169 context, N = 199 predictor) or random, about 60%
    kept."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((2, N, 2, d)).astype(np.float32) for _ in range(4))
    if kind == "collator":
        enc, pred = collator_masks(2)
        mask = enc if N == enc.shape[1] else pred[:2]
    else:
        mask = rng.random((2, N)) > 0.4
        mask[:, :3] = True
    qs = torch.from_numpy(q * d ** -0.5)
    return qs, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(do), mask


def jax_grads(qs, k, v, do, mask):
    """(o, dqs, dk, dv) through JAX's Pallas key-bias kernels in interpret
    mode (qs already scaled: scale 1)."""
    args = [jnp.asarray(x.numpy()) for x in (qs, k, v)]
    jmask = jnp.asarray(mask)
    o, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, scale=1.0, interpret=True,
                                               key_mask=jmask), *args)
    grads = vjp(jnp.asarray(do.numpy()))
    return [torch.from_numpy(np.array(x)) for x in (o, *grads)]


def shuffled(n: int, seed: int) -> list[int]:
    order = list(range(n))
    np.random.default_rng(seed).shuffle(order)
    return order


def close(got, want, tol):
    for x, r in zip(got, want):
        torch.testing.assert_close(x.float(), r.float(), rtol=tol, atol=tol)


CASES = [(169, 64, "collator"), (199, 32, "collator"), (197, 64, "random"),
         (197, 32, "random"), (169, 32, "random"), (199, 64, "random")]
IDS = [f"N{n}-d{d}-{kind}" for n, d, kind in CASES]


@pytest.mark.parametrize("N,d,kind", CASES, ids=IDS)
def test_schedule_matches_plain_and_jax(N, d, kind):
    qs, k, v, do, mask = inputs(N, d, kind, seed=N + d)
    bias = key_bias(torch.from_numpy(mask))
    o, lse = emulate_fwd(qs, k, v, bias)
    o_ref, lse_ref = flash_attention_fwd_ref(qs, k, v, bias)
    close((o, lse), (o_ref, lse_ref), TOL)
    grads = emulate_bwd(qs, k, v, o, lse, do, bias, shuffled(n_tiles(N), seed=1))
    close(grads, flash_attention_bwd_ref(qs, k, v, o, lse, do, bias), GRAD_TOL)
    jo, *jgrads = jax_grads(qs, k, v, do, mask)
    close((o,), (jo,), TOL)
    close(grads, jgrads, GRAD_TOL)
    # masked keys get no gradient at all (dead CTAs write zeros)
    keep = torch.from_numpy(mask)
    assert torch.all(grads[1][~keep] == 0) and torch.all(grads[2][~keep] == 0)


@pytest.mark.parametrize("N,d", [(169, 64), (199, 32)], ids=["context", "predictor"])
def test_dead_tiles_are_skipped_exactly(N, d):
    # the collator pads the context at its end: at 169 tokens the second
    # key tile is dead (fewer than 128 keys kept); skipping it gives the
    # same bits as taking it, whose every p is exp2(-1e30 log2 e - m) = 0
    qs, k, v, do, mask = inputs(N, d, "collator", seed=5)
    bias = key_bias(torch.from_numpy(mask))
    if N == 169:
        assert all(tiles == [0] for tiles in live_tiles(bias))
    skipped, every = emulate_fwd(qs, k, v, bias), emulate_fwd(qs, k, v, bias, skip=False)
    assert all(torch.equal(a, b) for a, b in zip(skipped, every))


@pytest.mark.parametrize("N,d", [(169, 64), (199, 32), (197, 64)], ids=["N169", "N199", "N197"])
def test_batch_element_with_no_key_takes_every_tile(N, d):
    # batch element 1 has no attendable key: uniform weights over its N keys,
    # LSE = +inf, and no gradient; dead CTAs everywhere in it
    qs, k, v, do, mask = inputs(N, d, "random", seed=N)
    mask[1] = False
    bias = key_bias(torch.from_numpy(mask))
    assert live_tiles(bias)[1] == list(range(n_tiles(N)))[::-1]
    o, lse = emulate_fwd(qs, k, v, bias)
    close((o, lse), flash_attention_fwd_ref(qs, k, v, bias), TOL)
    torch.testing.assert_close(o[1], v[1].mean(0).expand(N, -1, -1), rtol=TOL, atol=TOL)
    assert torch.isinf(lse[1]).all() and bool((lse[1] > 0).all()) and torch.isfinite(lse[0]).all()
    grads = emulate_bwd(qs, k, v, o, lse, do, bias, shuffled(n_tiles(N), seed=2))
    close(grads, flash_attention_bwd_ref(qs, k, v, o, lse, do, bias), GRAD_TOL)
    assert all(torch.all(g[1] == 0) for g in grads)


@pytest.mark.parametrize("N,d", [(169, 64), (199, 32)], ids=["N169", "N199"])
def test_keys_past_n_get_minus_inf(N, d):
    # whatever the rows past N hold, -inf keeps them out; at -1e30 they would
    # tie with the masked keys of a row that has no attendable key, which
    # would then average over the padded tile, as the TPU does over Np
    qs, k, v, do, mask = inputs(N, d, "random", seed=N + 1)
    mask[0] = False
    bias = key_bias(torch.from_numpy(mask))
    zero, junk = emulate_fwd(qs, k, v, bias), emulate_fwd(qs, k, v, bias, fill=300.0)
    assert all(torch.equal(a, b) for a, b in zip(zero, junk))
    order = list(range(n_tiles(N)))
    assert all(torch.equal(a, b) for a, b in zip(
        emulate_bwd(qs, k, v, *zero, do, bias, order),
        emulate_bwd(qs, k, v, *zero, do, bias, order, fill=300.0)))
    tied, _ = emulate_fwd(qs, k, v, bias, pad_bias=NEG_INF)
    ref, _ = flash_attention_fwd_ref(qs, k, v, bias)
    close((zero[0],), (ref,), TOL)
    assert not torch.allclose(tied[0], ref[0], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("N,d", [(199, 32), (197, 64)], ids=["N199", "N197"])
def test_two_reduce_orders_agree(N, d):
    # dQ's parts land in the accumulator in another order on every run: two
    # orders give dQ within the tolerance of each other, and dK/dV bit for bit
    qs, k, v, do, mask = inputs(N, d, "random", seed=N + 2)
    bias = key_bias(torch.from_numpy(mask))
    o, lse = emulate_fwd(qs, k, v, bias)
    a = emulate_bwd(qs, k, v, o, lse, do, bias, list(range(n_tiles(N))))
    b = emulate_bwd(qs, k, v, o, lse, do, bias, shuffled(n_tiles(N), seed=7)[::-1])
    close(a, b, GRAD_TOL)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
