"""Ring attention (slice 7c): the port's ``ring_attention_chunks`` (one
process, S chunks) and ``ring_attention`` over 2 and 4 gloo ranks against
the JAX package's ``bvc_tpu.ops.ring_attention.ring_attention`` under
``shard_map`` on the 8-device CPU mesh, in f32: unmasked, with a key mask,
with samples whose keys are all masked, and the gradients.  The hops run
the flash kernels' plain versions on CPU tensors (the custom operators).

Tolerances, ``tests/test_ring_attention.py``'s: rtol/atol 1e-5 for outputs,
1e-4 for gradients.  A sample whose every key is masked gets uniform
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
from bvc_tpu_torch.ops.attention import multi_head_attention
from bvc_tpu_torch.ops.ring_attention import ring_attention_chunks
from torch_ranks import run_ranks

B, N, H, D = 2, 32, 3, 8


def _case(seed: int, mask: str | None = None) -> dict:
    rng = np.random.default_rng(seed)
    case = {x: rng.standard_normal((B, N, H, D)).astype(np.float32) for x in "qkvg"}
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


def _jax(case: dict, S: int) -> dict:
    """The JAX ring's output and the gradients of sum(o * g) on a seq mesh of S."""
    mesh = Mesh(np.array(jax.devices()[:S]), ("seq",))
    spec = P(None, "seq", None, None)
    masked = "mask" in case

    def loss(q, k, v, g, *km):
        o = jax_ring(q, k, v, "seq", key_mask=km[0] if masked else None)
        return jax.lax.psum(jnp.sum(o * g), "seq"), o

    in_specs = (spec,) * 4 + ((P(None, "seq"),) if masked else ())
    fn = jax.shard_map(loss, mesh=mesh, in_specs=in_specs, out_specs=(P(), spec))
    args = [jnp.asarray(case[x]) for x in "qkv"] + [jnp.asarray(_out_grad(case))]
    args += [jnp.asarray(case["mask"])] if masked else []
    (_, o), grads = jax.jit(jax.value_and_grad(fn, argnums=(0, 1, 2), has_aux=True))(*args)
    return {"o": np.asarray(o), **{n: np.asarray(g) for n, g in zip(("dq", "dk", "dv"), grads)}}


def _port_chunks(case: dict, S: int) -> dict:
    q, k, v = (torch.from_numpy(case[x]).requires_grad_(True) for x in "qkv")
    mask = torch.from_numpy(case["mask"]) if "mask" in case else None
    o = ring_attention_chunks(q, k, v, S, key_mask=mask)
    (o * torch.from_numpy(_out_grad(case))).sum().backward()
    return {"o": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy()}


def _assert_match(got: dict, want: dict, what: str) -> None:
    np.testing.assert_allclose(got["o"], want["o"], rtol=1e-5, atol=1e-5, err_msg=what)
    for name in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("name", list(CASES))
def test_chunks_match_jax_ring(name, S):
    case = CASES[name]
    got = _port_chunks(case, S)
    assert np.isfinite(got["o"]).all()
    _assert_match(got, _jax(case, S), f"{name} S={S}")


def test_chunks_route_and_launch_the_custom_ops(monkeypatch):
    """Each hop is one call of ``flash_fwd`` (forward) and one of
    ``flash_bwd`` (backward) over the S stacked query chunks, whatever the
    chunks' length; the merged LSE is the whole sequence's."""
    from bvc_tpu_torch.ops import ring_attention as ring_mod

    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ring_mod.flash_fwd, ring_mod.flash_bwd

    def counted(kind, fn):
        def call(*args):
            calls[kind] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(ring_mod, "flash_fwd", counted("fwd", fwd))
    monkeypatch.setattr(ring_mod, "flash_bwd", counted("bwd", bwd))
    case = CASES["unmasked"]
    q, k, v = (torch.from_numpy(case[x]).requires_grad_(True) for x in "qkv")
    o, lse = ring_attention_chunks(q, k, v, 4, return_lse=True)
    o.sum().backward()
    assert calls == {"fwd": 4, "bwd": 4}
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
