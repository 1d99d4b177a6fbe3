"""The port's flash attention (plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode and its XLA attention.

Tolerance: 1e-5 absolute and relative in f32, where the two sides differ
only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.ops.attention import _xla_attention
from bvc_tpu.ops.flash_attention import flash_attention as jax_flash
from bvc_tpu_torch.ops._build import kernel_layout
from bvc_tpu_torch.ops.attention import multi_head_attention, plain_attention
from bvc_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_fwd,
    flash_attention_fwd_ref,
    flash_fwd_cuda,
)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, N, h, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, h, d)).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("N", [128, 100], ids=["divisor", "padded"])
def test_flash_plain_matches_jax_interpret(N):
    # N=128 takes the JAX divisor path; N=100 is padded to 128 with
    # n_valid=100 and masked key columns
    q, k, v = _qkv(2, N, 3, 16, seed=N)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               interpret=True))
    out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("N", [128, 100], ids=["divisor", "padded"])
def test_flash_plain_matches_jax_xla_attention(N):
    q, k, v = _qkv(2, N, 3, 16, seed=N + 1)
    scale = 16 ** -0.5
    ref = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    np.testing.assert_allclose(flash_attention(tq, tk, tv).numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(plain_attention(tq, tk, tv, scale).numpy(), ref,
                               rtol=TOL, atol=TOL)


def test_lse_matches_numpy_logsumexp():
    q, k, v = _qkv(2, 100, 3, 16, seed=7)
    qs = q * 16 ** -0.5
    _, lse = flash_attention_fwd_ref(*(torch.from_numpy(x) for x in (qs, k, v)))
    s = np.einsum("bqhd,bkhd->bhqk", qs.astype(np.float64), k.astype(np.float64))
    m = s.max(-1, keepdims=True)
    ref = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == (2, 3, 100) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), ref, rtol=TOL, atol=TOL)


def test_flash_plain_bf16_matches_jax_interpret():
    # bf16 in and out, P rounded to bf16 before P.V on both sides; the two
    # frameworks round bf16 at other places, so the bound is bf16's (2^-7)
    q, k, v = _qkv(1, 128, 2, 16, seed=3)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(jax_flash(jq, jk, jv, interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=1e-2, atol=1e-2)


def test_cpu_dispatch_is_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 40, 2, 16, seed=5))
    o, lse = flash_attention_fwd(q, k, v)
    o_ref, lse_ref = flash_attention_fwd_ref(q, k, v)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)


def test_kernel_wrapper_refuses_cpu_tensors():
    # the CUDA wrapper never runs anything but the kernel
    q = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16)
    launches = flash_fwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA bf16"):
        flash_fwd_cuda(q, q, q)
    assert flash_fwd_cuda.launches == launches


def test_kernel_reads_qkv_slices_without_a_copy():
    # the block hands the kernel strided q/k/v slices of one fused qkv
    # tensor; rows start on 16 bytes, so they go in as they are
    qkv = torch.zeros(2, 40, 3, 4, 64, dtype=torch.bfloat16)
    for i in range(3):
        x = qkv[:, :, i]
        assert kernel_layout(x) is x
    # a transposed head width or a row off the 16-byte grid is copied
    t = torch.zeros(2, 40, 64, 4, dtype=torch.bfloat16).transpose(-1, -2)
    assert kernel_layout(t).is_contiguous() and kernel_layout(t) is not t
    odd = torch.zeros(2 * 40 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 40, 4, 64)
    assert kernel_layout(odd) is not odd and kernel_layout(odd).data_ptr() % 16 == 0


def test_flash_refuses_gradients():
    # no gradient is refused: they flow through the autograd Function, and
    # a no_grad call runs the forward alone
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(1, 16, 1, 8, seed=0))
    out = flash_attention(q, k, v)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    assert all(g.shape == (1, 16, 1, 8) and torch.isfinite(g).all() for g in grads)
    with torch.no_grad():
        out = flash_attention(q, k, v)
        assert out.shape == (1, 16, 1, 8) and out.grad_fn is None


def test_routing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 24, 2, 8, seed=1))
    plain = plain_attention(q, k, v, 8 ** -0.5)
    # on the CPU 'auto' is the plain math, whatever N
    assert torch.equal(multi_head_attention(q, k, v), plain)
    assert torch.equal(multi_head_attention(q, k, v, impl="xla"), plain)
    torch.testing.assert_close(multi_head_attention(q, k, v, impl="flash"), plain,
                               rtol=TOL, atol=TOL)
    # a key mask takes the key-bias kernels' plain version on the CPU
    mask = torch.ones(1, 24, dtype=torch.bool)
    mask[0, 5] = False
    torch.testing.assert_close(multi_head_attention(q, k, v, impl="flash", key_mask=mask),
                               plain_attention(q, k, v, 8 ** -0.5, mask), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="unknown attention impl"):
        multi_head_attention(q, k, v, impl="ring:seq")


def test_key_mask_matches_jax():
    q, k, v = _qkv(2, 30, 2, 8, seed=11)
    mask = np.random.default_rng(12).random((2, 30)) > 0.4
    mask[:, :3] = True
    ref = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    8 ** -0.5, key_mask=jnp.asarray(mask)))
    out = multi_head_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               key_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
