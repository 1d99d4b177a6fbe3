"""The port's masked flash attention (the key-bias kernels' plain versions on
the CPU) against ``bvc_tpu.ops.flash_attention.flash_attention(...,
key_mask=..., interpret=True)``, which runs the Pallas ``_fwd_kernel_bias``,
``_dq_kernel_bias`` and ``_dkv_kernel_bias`` in interpret mode; the routing
rule; and ``'xla_bf16'`` against ``_xla_attention(score_dtype=bf16)``.

Tolerances: forward 1e-5 and gradients 1e-4, absolute and relative, in f32,
as the JAX package's own key-mask tests (``tests/test_ops.py``); masked
keys' dK and dV exactly 0; ``'xla_bf16'`` 1e-5, since both sides round the
same f32 logits to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.ops.attention import _xla_attention
from bvc_tpu.ops.flash_attention import flash_attention as jax_flash
from bvc_tpu_torch.ops.attention import (FLASH_MIN_MASKED_TOKENS, FLASH_MIN_TOKENS,
                                         attention_route, multi_head_attention,
                                         plain_attention)
from bvc_tpu_torch.ops.flash_attention import (NEG_INF, flash_attention,
                                               flash_attention_bwd_ref,
                                               flash_attention_fwd_ref, flash_bwd_cuda,
                                               flash_fwd_cuda, key_bias, resolve_bias)

TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, N, h, d, seed):
    """q, k, v, the weights of a weighted-sum loss and a key mask that
    keeps about 60% of the keys (and always the first four)."""
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((B, N, h, d)).astype(np.float32) for _ in range(4))
    mask = rng.random((B, N)) > 0.4
    mask[:, :4] = True
    return q, k, v, w, mask


@pytest.mark.parametrize("d", [64, 32])
@pytest.mark.parametrize("N", [130, 300], ids=["N130", "N300"])
def test_masked_flash_matches_jax_interpret(N, d):
    # N=130 and 300 take 3 and 5 key tiles of 64; the JAX side pads to 256
    # and 384 with masked columns
    q, k, v, w, mask = _inputs(2, N, 2, d, seed=N + d)
    jmask = jnp.asarray(mask)

    def jax_loss(a, b, c):
        return jnp.sum(jax_flash(a, b, c, interpret=True, key_mask=jmask) * w)

    jargs = [jnp.asarray(x) for x in (q, k, v)]
    ref = np.asarray(jax_flash(*jargs, interpret=True, key_mask=jmask))
    ref_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(*jargs)

    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*args, key_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=TOL, atol=TOL)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), args)
    for name, g, r in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name}")
    # masked keys get no gradient at all
    assert np.all(grads[1].numpy()[~mask] == 0) and np.all(grads[2].numpy()[~mask] == 0)


def test_masked_grads_match_plain_attention_autograd():
    q, k, v, w, mask = _inputs(2, 70, 3, 32, seed=4)
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    m, wt = torch.from_numpy(mask), torch.from_numpy(w)
    out = flash_attention(*args, key_mask=m)
    ref = plain_attention(*args, 32 ** -0.5, m)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    for g, r in zip(torch.autograd.grad((out * wt).sum(), args),
                    torch.autograd.grad((ref * wt).sum(), args)):
        torch.testing.assert_close(g, r, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_fully_masked_row_is_uniform_and_passes_no_gradient():
    # batch element 1 has every key masked: uniform weights over its N keys
    # (what plain attention gives, no NaN), LSE = +inf, and no gradient
    q, k, v, w, mask = _inputs(2, 90, 2, 64, seed=9)
    mask[1] = False
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    m = torch.from_numpy(mask)
    out = flash_attention(*args, key_mask=m)
    torch.testing.assert_close(out, plain_attention(*args, 64 ** -0.5, m),
                               rtol=TOL, atol=TOL)
    torch.testing.assert_close(out[1], args[2][1].mean(0).expand(90, -1, -1),
                               rtol=TOL, atol=TOL)
    with torch.no_grad():
        _, lse = flash_attention_fwd_ref(args[0] * 0.125, args[1], args[2], key_bias(m))
    assert torch.isinf(lse[1]).all() and torch.isfinite(lse[0]).all()
    dq, dk, dv = torch.autograd.grad((out * torch.from_numpy(w)).sum(), args)
    assert torch.all(dq[1] == 0) and torch.all(dk[~m] == 0) and torch.all(dv[~m] == 0)
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))


def test_key_bias_and_plain_versions():
    mask = torch.tensor([[True, False, True]])
    bias = key_bias(mask)
    assert torch.equal(bias, torch.tensor([[0.0, NEG_INF, 0.0]], dtype=torch.float32))
    # a float 0/1 mask is refused, not read as a bias
    with pytest.raises(TypeError, match="bool"):
        key_bias(mask.float())
    assert resolve_bias(mask, None).equal(bias) and resolve_bias(None, bias) is bias
    assert resolve_bias(None, None) is None
    with pytest.raises(ValueError, match="not both"):
        resolve_bias(mask, bias)
    # the bias built once gives what the mask gives, on both paths
    q, k, v, _, m = _inputs(2, 40, 2, 32, seed=5)
    args, m = [torch.from_numpy(x) for x in (q, k, v)], torch.from_numpy(m)
    for impl in ("xla", "flash"):
        assert torch.equal(multi_head_attention(*args, impl=impl, key_mask=m),
                           multi_head_attention(*args, impl=impl, bias=key_bias(m)))
    # the plain backward with a zero bias is the unmasked one
    q, k, v, w, _ = _inputs(1, 40, 2, 32, seed=3)
    qs, k, v, do = (torch.from_numpy(x) for x in (q * 32 ** -0.5, k, v, w))
    o, lse = flash_attention_fwd_ref(qs, k, v)
    o_b, lse_b = flash_attention_fwd_ref(qs, k, v, torch.zeros(1, 40))
    assert torch.equal(o, o_b) and torch.equal(lse, lse_b)
    for a, b in zip(flash_attention_bwd_ref(qs, k, v, o, lse, do),
                    flash_attention_bwd_ref(qs, k, v, o, lse, do, torch.zeros(1, 40))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device,dtype,n,d,masked,route", [
    ("cuda", torch.bfloat16, 392, 64, False, "flash"),    # JEPA target encoder
    ("cuda", torch.bfloat16, 169, 64, True, "flash"),     # JEPA context encoder
    ("cuda", torch.bfloat16, 199, 32, True, "flash"),     # JEPA predictor
    ("cuda", torch.bfloat16, 1568, 32, False, "flash"),   # Hiera's decoder: unmasked d=32
    ("cuda", torch.bfloat16, 1568, 80, False, "xla"),     # ViT-H: d=80
    ("cuda", torch.bfloat16, 1568, 88, True, "xla"),      # ViT-g: d=88
    ("cuda", torch.bfloat16, FLASH_MIN_TOKENS - 1, 64, False, "xla"),
    ("cuda", torch.bfloat16, FLASH_MIN_MASKED_TOKENS, 64, True, "flash"),
    ("cuda", torch.bfloat16, FLASH_MIN_MASKED_TOKENS, 32, True, "flash"),
    ("cuda", torch.bfloat16, FLASH_MIN_MASKED_TOKENS - 1, 32, True, "xla"),
    ("cuda", torch.float32, 1568, 64, False, "xla"),
    ("cpu", torch.bfloat16, 1568, 64, True, "xla"),
], ids=["target", "context", "predictor", "d32-unmasked", "vit-h", "vit-g", "short",
        "masked-128-d64", "masked-128-d32", "masked-short", "f32", "cpu"])
def test_attention_route(device, dtype, n, d, masked, route):
    assert attention_route(device, dtype, n, d, masked) == route


def test_xla_bf16_matches_jax():
    q, k, v, _, mask = _inputs(2, 40, 2, 16, seed=21)
    scale = 16 ** -0.5
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    targs = [torch.from_numpy(x) for x in (q, k, v)]
    for m in (None, mask):
        ref = np.asarray(_xla_attention(*jargs, scale, None if m is None else jnp.asarray(m),
                                        jnp.bfloat16))
        out = multi_head_attention(*targs, impl="xla_bf16",
                                   key_mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
        # the bf16 logits differ from the f32 ones
        f32 = plain_attention(*targs, scale, None if m is None else torch.from_numpy(m))
        assert not torch.equal(out, f32)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    # CPU tensors never run anything but the kernels, and the counters stay
    x = torch.zeros(1, 8, 1, 32, dtype=torch.bfloat16)
    bias = torch.zeros(1, 8)
    counters = ((flash_fwd_cuda, "launches_bias"), (flash_bwd_cuda, "launches_prep_bias"),
                (flash_bwd_cuda, "launches_fused_bias"), (flash_bwd_cuda, "launches_post_bias"))
    counts = [getattr(fn, name) for fn, name in counters]
    with pytest.raises(ValueError, match="CUDA bf16"):
        flash_fwd_cuda(x, x, x, bias)
    with pytest.raises(ValueError, match="CUDA bf16"):
        flash_bwd_cuda(x, x, x, x, torch.zeros(1, 1, 8), x, bias)
    assert [getattr(fn, name) for fn, name in counters] == counts
