"""The GELU operators ``bvc_tpu_torch::gelu_poly`` and ``::gelu_poly_bwd``
on CPU tensors: the forward is the eager ``gelu_poly`` bit for bit, the
backward is autograd's gradient through the eager chain bit for bit and
``jax.grad`` of the JAX package's ``gelu_poly`` to 1e-6; fakes, opcheck,
the CUDA kernels' registration, the routing of ``gelu()`` by dtype inside
its ``bvc::gelu`` range, what autograd saves, the kernels' coefficients,
and a bf16 serving artifact holding one operator a block.  The kernels
themselves run in ``chip_smoke.py`` on the card."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bvc_tpu.ops.gelu import gelu_poly as jax_gelu_poly
from bvc_tpu_torch.models.videomae import VideoMAEEncoder
from bvc_tpu_torch.ops import _build
from bvc_tpu_torch.ops.gelu import (GELU_ERF_POLY_COEF, gelu, gelu_poly, gelu_poly_bwd_op,
                                    gelu_poly_bwd_ref, gelu_poly_op)
from bvc_tpu_torch.serving.export import export_embed, kernel_ops, load_artifact, save_artifact
from bvc_tpu_torch.utils.config import ModelConfig

SPECIALS = [4.0, -4.0, float("inf"), float("-inf"), float("nan"), 0.0, -0.0]


def _inputs(dtype: torch.dtype, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """x: a linspace over [-6, 6], normal draws of scale 2 and
    :data:`SPECIALS`; dy: normal draws; both ``dtype``."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([np.linspace(-6, 6, 4001), 2 * rng.standard_normal(4000), SPECIALS])
    dy = rng.standard_normal(x.shape)
    return (torch.from_numpy(x.astype(np.float32)).to(dtype),
            torch.from_numpy(dy.astype(np.float32)).to(dtype))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _autograd_through_the_chain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    xr = x.clone().requires_grad_()
    gelu_poly(xr).backward(dy)
    return xr.grad


def test_cpu_forward_is_the_eager_chain_bit_for_bit():
    x, _ = _inputs(torch.bfloat16)
    y = gelu_poly_op(x)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape and y.is_contiguous()
    assert torch.equal(_bits(y), _bits(gelu_poly(x)))
    x3 = x[:4000].reshape(4, 10, 100).transpose(1, 2)  # strided: out contiguous, same values
    assert torch.equal(_bits(gelu_poly_op(x3)), _bits(gelu_poly(x3).contiguous()))
    assert gelu_poly_op(torch.empty((0, 3), dtype=torch.bfloat16)).shape == (0, 3)


def test_backward_matches_jax_grad():
    x, _ = _inputs(torch.float32)
    x = x[torch.isfinite(x)]
    want = np.asarray(jax.vmap(jax.grad(jax_gelu_poly))(jnp.asarray(x.numpy())))
    ones = torch.ones_like(x)
    for got in (gelu_poly_bwd_ref(x, ones), gelu_poly_bwd_op(x, ones)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_is_autograd_through_the_eager_chain(dtype):
    """Bit for bit (so within one bf16 ulp), NaN where autograd gives NaN
    (at +-inf, and where P(u) overflows)."""
    x, dy = _inputs(dtype, seed=1)
    x = torch.cat([x, torch.tensor([1e4, -1e4], dtype=dtype)])
    dy = torch.cat([dy, torch.ones(2, dtype=dtype)])
    want = _autograd_through_the_chain(x, dy)
    for got in (gelu_poly_bwd_ref(x, dy), gelu_poly_bwd_op(x, dy)):
        assert got.dtype == dtype and torch.equal(_bits(got), _bits(want))
    assert bool(want[-2:].isnan().all())


def test_gelu_gradient_is_the_backward_op_and_saves_only_x():
    x, dy = _inputs(torch.bfloat16, seed=2)
    x = x.reshape(1, -1).requires_grad_()
    dy = dy.reshape(1, -1)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        y = gelu(x)
    y.backward(dy)
    assert len(saved) == 1 and saved[0].dtype == torch.bfloat16 and saved[0].shape == x.shape
    assert torch.equal(_bits(x.grad), _bits(gelu_poly_bwd_ref(x.detach(), dy)))


@pytest.mark.parametrize("dtype,op_calls", [(torch.bfloat16, 1), (torch.float32, 0),
                                            (torch.float16, 0)])
def test_gelu_routes_by_dtype(dtype, op_calls):
    """bf16 takes the operator, f32 exact erf, f16 the eager chain."""
    from torch.profiler import ProfilerActivity, profile

    x, _ = _inputs(dtype)
    x = x[torch.isfinite(x)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = gelu(x)
    names = [e.name for e in prof.events()]
    assert names.count("bvc_tpu_torch::gelu_poly") == op_calls
    assert names.count("bvc::gelu") == 1
    want = F.gelu(x, approximate="none") if dtype == torch.float32 else gelu_poly(x)
    assert y.dtype == dtype and torch.equal(y, want)


def test_the_operator_runs_inside_the_gelu_range():
    from torch.profiler import ProfilerActivity, profile

    x = _inputs(torch.bfloat16)[0].requires_grad_()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gelu(x).sum().backward()
    events = {e.name: e.time_range for e in prof.events()
              if e.name in ("bvc::gelu", "bvc_tpu_torch::gelu_poly")}
    outer, inner = events["bvc::gelu"], events["bvc_tpu_torch::gelu_poly"]
    assert outer.start <= inner.start and inner.end <= outer.end
    assert "bvc_tpu_torch::gelu_poly_bwd" in {e.name for e in prof.events()}


def test_fakes_give_shapes_and_dtypes_and_hold_the_kernels_limits():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.bfloat16),
                              ("cpu", torch.float32)):
            x = torch.empty((2, 5, 6), dtype=dtype, device=device).transpose(1, 2)
            for out in (gelu_poly_op(x), gelu_poly_bwd_op(x, x)):
                assert out.shape == (2, 6, 5) and out.dtype == dtype
                assert out.device.type == device and out.is_contiguous()
        half = torch.empty((2, 8), dtype=torch.float16, device="cuda")
        with pytest.raises(ValueError, match="CUDA bf16"):
            gelu_poly_op(half)
        a, b = (torch.empty(s, dtype=torch.bfloat16, device="cuda") for s in ((2, 8), (2, 4)))
        with pytest.raises(ValueError, match="differ in shape"):
            gelu_poly_bwd_op(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_opcheck(dtype):
    x, dy = _inputs(dtype, seed=3)
    x, dy = x[torch.isfinite(x)][:64].reshape(4, 16), dy[:64].reshape(4, 16)
    torch.library.opcheck(gelu_poly_op, (x.clone().requires_grad_(),))
    torch.library.opcheck(gelu_poly_bwd_op, (x, dy))


@pytest.mark.parametrize("op", ["gelu_poly", "gelu_poly_bwd"])
def test_cuda_kernel_registered(op):
    name = f"bvc_tpu_torch::{op}"
    for key in ("CPU", "CUDA", "Meta"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key), (op, key)


def test_kernel_coefficients_are_gelu_erf_poly_coef():
    """``csrc/gelu.cu`` rounds the same doubles to f32, c0 .. c7."""
    src = (_build.CSRC_DIR / "gelu.cu").read_text()
    found = re.findall(r"constexpr float kC(\d) = static_cast<float>\(([^)]+)\);", src)
    assert [int(k) for k, _ in found] == list(range(8))
    assert tuple(float(v) for _, v in found) == GELU_ERF_POLY_COEF
    assert "constexpr float kClamp = 4.0f;" in src


def test_bf16_artifact_holds_one_gelu_poly_a_block(tmp_path):
    cfg = ModelConfig(image_size=32, patch_size=8, num_frames=4, tubelet_size=2,
                      hidden_size=32, depth=3, num_heads=4, dtype="bfloat16")
    model = VideoMAEEncoder(cfg)
    exported, meta = export_embed("videomae", model, cfg, device="cpu")
    assert kernel_ops(exported) == {"gelu_poly": cfg.depth}
    fn = load_artifact(save_artifact(tmp_path / "port", exported, meta), device="cpu")
    video = np.random.default_rng(4).integers(0, 256, (2, 4, 32, 32, 3), dtype=np.uint8)
    with torch.no_grad():
        want = model.eval().embed(torch.from_numpy(video)).float().numpy()
    np.testing.assert_array_equal(fn(video), want)
