"""Ring attention (slice 7c): the port's ``ring_attention_chunks`` (one
process, S chunks) and ``ring_attention`` over 2 and 4 gloo ranks against
the JAX package's ``bvc_tpu.ops.ring_attention.ring_attention`` under
``shard_map`` on the 8-device CPU mesh, in f32: unmasked, with a key mask,
with samples whose keys are all masked, and the gradients.  CPU tensors
take the ring's plain route (each hop's O and LSE in f32 torch, the JAX
ring's math); the flash route's hops (the custom operators, whose CPU
implementations are the kernels' plain versions) are held to the same
results with the route forced.  The plain route also at head widths 16 and
64 in f32 and at 16 in bf16, the inputs for which a CUDA ring takes it; the
route rule itself on a mocked ``cuda`` device type.

Tolerances, ``tests/test_ring_attention.py``'s: rtol/atol 1e-5 for outputs,
1e-4 for gradients; in bf16, one bf16 ulp at max|JAX's| (2^-7 of it: the
two round the same f32 sums to bf16, read: outputs equal, gradients one ulp
apart).  A sample whose every key is masked gets uniform
weights over every key in both packages; its gradient is zero in the port
(LSE = +inf, as its flash path gives), so the gradients are compared with
its output gradient set to zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bvc_tpu.ops.ring_attention import ring_attention as jax_ring
from bvc_tpu_torch.ops import ring_attention as ring_mod
from bvc_tpu_torch.ops.attention import multi_head_attention
from bvc_tpu_torch.ops.flash_attention import kernel_route
from bvc_tpu_torch.ops.ring_attention import ring_attention_chunks
from torch_ranks import run_ranks

B, N, H, D = 2, 32, 3, 8


def _case(seed: int, mask: str | None = None, d: int = D) -> dict:
    rng = np.random.default_rng(seed)
    case = {x: rng.standard_normal((B, N, H, d)).astype(np.float32) for x in "qkvg"}
    if mask == "random":
        case["mask"] = rng.random((B, N)) > 0.3
        case["mask"][0, : N // 2] = False  # every key of the first half of sample 0
    elif mask == "fully":
        case["mask"] = np.zeros((B, N), bool)
        case["mask"][1] = True  # sample 0 has no key
    return case


CASES = {"unmasked": _case(0), "masked": _case(1, "random"), "fully_masked": _case(2, "fully")}


def _out_grad(case: dict) -> np.ndarray:
    g = case["g"].copy()
    if "mask" in case:
        g[~case["mask"].any(1)] = 0.0  # a sample without keys: no gradient in the port
    return g


def _jax(case: dict, S: int, dtype: str = "float32") -> dict:
    """The JAX ring's output and the gradients of sum(o * g) on a seq mesh of
    S, q, k and v in ``dtype``; returned in f32."""
    mesh = Mesh(np.array(jax.devices()[:S]), ("seq",))
    spec = P(None, "seq", None, None)
    masked = "mask" in case

    def loss(q, k, v, g, *km):
        o = jax_ring(q, k, v, "seq", key_mask=km[0] if masked else None)
        return jax.lax.psum(jnp.sum(o.astype(jnp.float32) * g), "seq"), o

    in_specs = (spec,) * 4 + ((P(None, "seq"),) if masked else ())
    fn = jax.shard_map(loss, mesh=mesh, in_specs=in_specs, out_specs=(P(), spec))
    args = [jnp.asarray(case[x]).astype(dtype) for x in "qkv"] + [jnp.asarray(_out_grad(case))]
    args += [jnp.asarray(case["mask"])] if masked else []
    (_, o), grads = jax.jit(jax.value_and_grad(fn, argnums=(0, 1, 2), has_aux=True))(*args)
    return {"o": np.asarray(o, np.float32),
            **{n: np.asarray(g, np.float32) for n, g in zip(("dq", "dk", "dv"), grads)}}


def _port_chunks(case: dict, S: int, dtype: torch.dtype = torch.float32) -> dict:
    q, k, v = (torch.from_numpy(case[x]).to(dtype).requires_grad_(True) for x in "qkv")
    mask = torch.from_numpy(case["mask"]) if "mask" in case else None
    o = ring_attention_chunks(q, k, v, S, key_mask=mask)
    assert o.dtype == dtype
    (o.float() * torch.from_numpy(_out_grad(case))).sum().backward()
    return {"o": o.detach().float().numpy(), "dq": q.grad.float().numpy(),
            "dk": k.grad.float().numpy(), "dv": v.grad.float().numpy()}


def _assert_match(got: dict, want: dict, what: str) -> None:
    np.testing.assert_allclose(got["o"], want["o"], rtol=1e-5, atol=1e-5, err_msg=what)
    for name in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{what} {name}")


def _assert_match_bf16(got: dict, want: dict, what: str) -> None:
    for name in ("o", "dq", "dk", "dv"):
        ulp = 2.0 ** -7 * np.abs(want[name]).max()
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=ulp,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("name", list(CASES))
def test_chunks_match_jax_ring(name, S):
    case = CASES[name]
    got = _port_chunks(case, S)
    assert np.isfinite(got["o"]).all()
    _assert_match(got, _jax(case, S), f"{name} S={S}")


def _count_hops(monkeypatch) -> dict:
    """Count the calls of each route's hop functions."""
    calls = {"flash_fwd": 0, "flash_bwd": 0, "plain_fwd": 0, "plain_bwd": 0}

    def counted(kind, fn):
        def call(*args):
            calls[kind] += 1
            return fn(*args)
        return call

    hops = {"flash": tuple(counted(f"flash_{p}", fn) for p, fn in
                           zip(("fwd", "bwd"), ring_mod.HOPS["flash"])),
            "xla": tuple(counted(f"plain_{p}", fn) for p, fn in
                         zip(("fwd", "bwd"), ring_mod.HOPS["xla"]))}
    monkeypatch.setattr(ring_mod, "HOPS", hops)
    return calls


def test_chunks_route_and_launch_the_custom_ops(monkeypatch):
    """On the flash route (forced here: CPU tensors take the plain one) each
    hop is one call of ``flash_fwd`` (forward) and one of ``flash_bwd``
    (backward) over the S stacked query chunks, whatever the chunks'
    length, with the plain route's results; the merged LSE is the whole
    sequence's.  Unforced, the hops are plain and call no operator."""
    case = CASES["unmasked"]
    calls = _count_hops(monkeypatch)
    plain = _port_chunks(case, 4)
    assert calls == {"flash_fwd": 0, "flash_bwd": 0, "plain_fwd": 4, "plain_bwd": 4}
    monkeypatch.setattr(ring_mod, "kernel_route", lambda *a: "flash")
    calls.update(dict.fromkeys(calls, 0))
    q, k, v = (torch.from_numpy(case[x]).requires_grad_(True) for x in "qkv")
    o, lse = ring_attention_chunks(q, k, v, 4, return_lse=True)
    (o * torch.from_numpy(_out_grad(case))).sum().backward()
    assert calls == {"flash_fwd": 4, "flash_bwd": 4, "plain_fwd": 0, "plain_bwd": 0}
    _assert_match({"o": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                   "dv": v.grad.numpy()}, plain, "flash route against plain route")
    s = torch.einsum("bqhd,bkhd->bhqk", q.detach(), k.detach()) * D ** -0.5
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="do not split"):
        ring_attention_chunks(q, k, v, 3)


def test_impl_string_without_a_group_is_one_hop():
    """``impl='ring:seq'`` in one process (no ``seq`` ring) is the whole
    attention: a ring of one."""
    case = CASES["masked"]
    q, k, v = (torch.from_numpy(case[x]) for x in "qkv")
    mask = torch.from_numpy(case["mask"])
    got = multi_head_attention(q, k, v, impl="ring:seq", key_mask=mask)
    want = multi_head_attention(q, k, v, impl="xla", key_mask=mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_over_gloo_ranks_matches_jax(world, tmp_path):
    """``multi_head_attention(impl='ring:seq')`` on each rank's block, over
    a ``seq`` ring of ``world`` gloo processes (``--mesh data=1,seq=world``),
    against the JAX ring on a seq mesh of the same size, for every case."""
    cases = {name: {**c, "g": _out_grad(c)} for name, c in CASES.items()}
    ranks = run_ranks("ring", {"mesh": {"data": 1, "seq": world}, "cases": cases},
                      tmp_path, world=world, module="torch_seq_ranks")
    for name, case in CASES.items():
        want = _jax(case, world)
        got = {k: np.concatenate([r[name][k] for r in ranks], axis=1)
               for k in ("o", "dq", "dk", "dv")}
        _assert_match(got, want, f"{name} over {world} ranks")


WIDE = {f"d{d}_{m or 'unmasked'}": _case(20 + d + (m is not None), m, d)
        for d in (16, 64) for m in (None, "random")}


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", list(WIDE))
def test_plain_route_f32_matches_jax_ring(name, S):
    """f32 at the kernels' width 64 and at 16, with and without a key mask:
    the inputs an f32 model's ring hands the plain route on the card."""
    case = WIDE[name]
    _assert_match(_port_chunks(case, S), _jax(case, S), f"f32 {name} S={S}")


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("mask", [None, "random"])
def test_plain_route_bf16_width16_matches_jax_ring(mask, S):
    """bf16 at head width 16, which no kernel takes: the plain route in
    both packages' bf16 steps."""
    case = _case(40 + S, mask, 16)
    _assert_match_bf16(_port_chunks(case, S, torch.bfloat16), _jax(case, S, "bfloat16"),
                       f"bf16 d16 {mask} S={S}")


def test_ring_route_rule(monkeypatch):
    """The route on a mocked ``cuda`` device type: the kernels for bf16 at 64
    (and at 32 with a key mask), plain for f32, for other widths, for an
    unmasked 32 and off CUDA; decided once a ring call, before its first
    hop, from the blocks' device, dtype and width."""
    bf16, f32 = torch.bfloat16, torch.float32
    for args in (("cuda", bf16, 64, False), ("cuda", bf16, 64, True), ("cuda", bf16, 32, True)):
        assert kernel_route(*args) == "flash", args
    for args in (("cuda", bf16, 32, False), ("cuda", bf16, 16, False), ("cuda", bf16, 16, True),
                 ("cuda", f32, 64, False), ("cuda", f32, 32, True), ("cpu", bf16, 64, False),
                 ("cuda", torch.float16, 64, False)):
        assert kernel_route(*args) == "xla", args
    seen = []
    monkeypatch.setattr(ring_mod, "kernel_route", lambda *a: seen.append(a) or kernel_route(*a))
    case = WIDE["d16_random"]
    _port_chunks(case, 4, torch.bfloat16)
    assert seen == [("cpu", bf16, 16, True)]
