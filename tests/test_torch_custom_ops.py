"""The port's kernels as ``torch.library`` custom operators, on CPU tensors:
``torch.library.opcheck`` (schema, fake implementation against the real
one, autograd registration, AOT dispatch with dynamic shapes) on
``bvc_tpu_torch::flash_fwd`` and ``::flash_bwd`` without and with a key
bias at head widths 64 and 32, a row whose every key is masked among them,
and on ``::gemm_s8`` (raw and dequant, to bf16 and f32, with and without a
bias) and ``::gemm_bf16``; each operator has a CUDA kernel registered, and
``flash_fwd``'s gradient is ``flash_bwd``'s plain version."""

import numpy as np
import pytest
import torch

from bvc_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd_ref,
                                               flash_attention_fwd_ref, flash_bwd, flash_fwd,
                                               key_bias)
from bvc_tpu_torch.ops.gemm import gemm_bf16, gemm_s8, int8_matmul_ref

OPS = ("flash_fwd", "flash_bwd", "gemm_s8", "gemm_bf16")


def _qkv(d: int, seed: int, B: int = 2, N: int = 7, h: int = 2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, N, h, d)).astype(np.float32))
            for _ in range(3)]


def _bias(B: int, N: int, seed: int, all_masked_row: bool) -> torch.Tensor:
    keep = torch.from_numpy(np.random.default_rng(seed).random((B, N)) < 0.6)
    keep[:, 0] = True
    if all_masked_row:
        keep[-1] = False  # a batch element with no attendable key
    return key_bias(keep)


CASES = [(64, None), (64, "bias"), (32, "bias"), (64, "all_masked"), (32, "all_masked")]


@pytest.mark.parametrize("d,mask", CASES)
def test_flash_fwd_opcheck(d, mask):
    qs, k, v = (x.requires_grad_() for x in _qkv(d, seed=d))
    bias = None if mask is None else _bias(2, 7, d, mask == "all_masked")
    torch.library.opcheck(flash_fwd, (qs, k, v, bias))
    o, lse = flash_fwd(qs, k, v, bias)
    want_o, want_lse = flash_attention_fwd_ref(qs, k, v, bias)
    torch.testing.assert_close(o, want_o, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)
    assert o.is_contiguous() and lse.is_contiguous() and not lse.requires_grad
    if mask == "all_masked":
        assert torch.isinf(lse[-1]).all()


@pytest.mark.parametrize("d,mask", CASES)
def test_flash_bwd_opcheck(d, mask):
    qs, k, v = _qkv(d, seed=d + 1)
    bias = None if mask is None else _bias(2, 7, d + 1, mask == "all_masked")
    o, lse = flash_attention_fwd_ref(qs, k, v, bias)
    do = torch.from_numpy(np.random.default_rng(5).standard_normal(o.shape).astype(np.float32))
    torch.library.opcheck(flash_bwd, (qs, k, v, o, lse, do, bias))
    got = flash_bwd(qs, k, v, o, lse, do, bias)
    for x, want in zip(got, flash_attention_bwd_ref(qs, k, v, o, lse, do, bias)):
        torch.testing.assert_close(x, want, rtol=0, atol=0)
        assert x.is_contiguous()


@pytest.mark.parametrize("d,mask", [(64, None), (32, "bias")])
def test_flash_attention_gradient_is_flash_bwd(d, mask):
    """``flash_attention``'s autograd runs ``flash_bwd``: its gradients
    equal the plain backward's on the forward's O and LSE, and the query
    scale reaches dQ through autograd."""
    q, k, v = (x.requires_grad_() for x in _qkv(d, seed=7))
    bias = None if mask is None else _bias(2, 7, 7, False)
    out = flash_attention(q, k, v, bias=bias)
    do = torch.from_numpy(np.random.default_rng(8).standard_normal(out.shape).astype(np.float32))
    out.backward(do)
    scale = d ** -0.5
    qs = (q * scale).detach()
    o, lse = flash_attention_fwd_ref(qs, k.detach(), v.detach(), bias)
    dqs, dk, dv = flash_attention_bwd_ref(qs, k.detach(), v.detach(), o, lse, do, bias)
    torch.testing.assert_close(out.detach(), o, rtol=0, atol=0)
    torch.testing.assert_close(q.grad, dqs * scale, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(k.grad, dk, rtol=0, atol=0)
    torch.testing.assert_close(v.grad, dv, rtol=0, atol=0)


def _s8(M: int, N: int, K: int, seed: int):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (N, K), dtype=np.int8))
    xscale = torch.from_numpy(rng.uniform(1e-3, 1e-2, M).astype(np.float32))
    wscale = torch.from_numpy(rng.uniform(1e-3, 1e-2, N).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    return a, b, xscale, wscale, bias


@pytest.mark.parametrize("epilogue", ["raw", "bf16", "f32", "bf16_bias", "f32_bias"])
def test_gemm_s8_opcheck(epilogue):
    a, b, xscale, wscale, bias = _s8(9, 12, 48, seed=3)
    if epilogue == "raw":
        args = (a, b, None, None, None, torch.bfloat16)
        want_dtype = torch.int32
    else:
        dtype = torch.bfloat16 if epilogue.startswith("bf16") else torch.float32
        args = (a, b, xscale, wscale, bias if epilogue.endswith("bias") else None, dtype)
        want_dtype = dtype
    torch.library.opcheck(gemm_s8, args)
    got = gemm_s8(*args)
    assert got.dtype == want_dtype and got.shape == (9, 12)
    torch.testing.assert_close(got, int8_matmul_ref(*args), rtol=0, atol=0)
    with pytest.raises(ValueError, match="need xscale"):
        gemm_s8(a, b, None, wscale, None, torch.float32)


def test_gemm_bf16_opcheck():
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
            for s in ((9, 32), (5, 32)))
    torch.library.opcheck(gemm_bf16, (a, b))
    got = gemm_bf16(a, b)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, a.float() @ b.float().T, rtol=0, atol=0)


@pytest.mark.parametrize("op", OPS)
def test_cuda_kernel_registered(op):
    """Each operator has its CUDA implementation (the kernel wrapper) and a
    fake (Meta) one beside the CPU one."""
    name = f"bvc_tpu_torch::{op}"
    for key in ("CPU", "CUDA", "Meta"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key), (op, key)


def test_fake_refuses_what_the_kernels_refuse():
    """On fake CUDA tensors (metadata only, no data) the fakes hold the
    kernels' own limits: head width 48 and K = 24 have no kernel."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty((2, 8, 2, 48), dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="head width 48"):
            flash_fwd(x, x, x, None)
        o, lse = flash_fwd(*(torch.empty((2, 8, 2, 64), dtype=torch.bfloat16,
                                         device="cuda"),) * 3, None)
        assert o.shape == (2, 8, 2, 64) and lse.shape == (2, 2, 8)
        assert lse.dtype == torch.float32
        a = torch.empty((4, 24), dtype=torch.int8, device="cuda")
        with pytest.raises(ValueError, match="multiple of 16"):
            gemm_s8(a, a, None, None, None, torch.bfloat16)
