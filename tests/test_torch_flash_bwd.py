"""Gradients of the port's flash attention (its autograd Function, whose
backward on CPU tensors is the kernels' plain version) against ``jax.grad``
through ``bvc_tpu.ops.flash_attention.flash_attention(..., interpret=True)``,
which runs the Pallas ``_dq_kernel`` and ``_dkv_kernel`` in interpret mode.

Tolerances: f32 1e-4 absolute and relative, as the JAX package's own
flash-gradient tests (``tests/test_ops.py``); bf16 2e-2 of the largest
entry, since the two frameworks round bf16 at other places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.ops.flash_attention import flash_attention as jax_flash
from bvc_tpu_torch.ops.attention import plain_attention
from bvc_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd,
                                               flash_attention_bwd_ref,
                                               flash_attention_fwd_ref, flash_bwd_cuda)

TOL = 1e-4
BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, N, h, d, seed):
    """q, k, v and the weights of a weighted-sum loss (so dO is not
    uniform), from numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, h, d)).astype(np.float32) for _ in range(4)]


def _jax_grads(q, k, v, w, dtype):
    def loss(a, b, c):
        out = jax_flash(a, b, c, interpret=True).astype(jnp.float32)
        return jnp.sum(out * w)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    return [np.asarray(g.astype(jnp.float32)) for g in
            jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _port_grads(q, k, v, w, dtype):
    args = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    loss = (flash_attention(*args).float() * torch.from_numpy(w)).sum()
    return [g.float().numpy() for g in torch.autograd.grad(loss, args)]


@pytest.mark.parametrize("N", [64, 90], ids=["divisor", "padded"])
def test_flash_grads_match_jax_interpret(N):
    # N=64 takes the JAX divisor path; N=90 is padded to 128 with masked
    # key columns
    q, k, v, w = _inputs(2, N, 2, 16, seed=N)
    ref = _jax_grads(q, k, v, w, jnp.float32)
    for name, out, r in zip("qkv", _port_grads(q, k, v, w, torch.float32), ref):
        np.testing.assert_allclose(out, r, rtol=TOL, atol=TOL, err_msg=f"d{name}")


def test_flash_grads_bf16_match_jax_interpret():
    q, k, v, w = _inputs(1, 128, 2, 16, seed=3)
    ref = _jax_grads(q, k, v, w, jnp.bfloat16)
    for name, out, r in zip("qkv", _port_grads(q, k, v, w, torch.bfloat16), ref):
        err = np.abs(out - r).max()
        assert err <= BF16_TOL * np.abs(r).max(), (f"d{name}", err)


def test_bwd_ref_matches_autograd_of_plain_attention():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 50, 3, 16, seed=7))
    qs = (q * 16 ** -0.5).requires_grad_()
    k, v = k.requires_grad_(), v.requires_grad_()
    with torch.no_grad():
        o, lse = flash_attention_fwd_ref(qs, k, v)
    dqs, dk, dv = flash_attention_bwd_ref(qs, k, v, o, lse, do)
    ref = torch.autograd.grad(plain_attention(qs, k, v, 1.0), (qs, k, v), do)
    for name, out, r in zip("qkv", (dqs, dk, dv), ref):
        torch.testing.assert_close(out, r, rtol=TOL, atol=TOL, msg=f"d{name}")


def test_cpu_dispatch_is_the_plain_version():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 40, 2, 16, seed=5))
    o, lse = flash_attention_fwd_ref(q, k, v)
    out = flash_attention_bwd(q, k, v, o, lse, do)
    ref = flash_attention_bwd_ref(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_kernel_wrapper_refuses_cpu_tensors():
    # the CUDA wrapper never runs anything but the kernels
    x = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 8)
    counts = flash_bwd_cuda.launches_dq, flash_bwd_cuda.launches_dkv
    with pytest.raises(ValueError, match="CUDA bf16"):
        flash_bwd_cuda(x, x, x, x, lse, x)
    assert (flash_bwd_cuda.launches_dq, flash_bwd_cuda.launches_dkv) == counts
