"""The LayerNorm operators ``bvc_tpu_torch::layer_norm`` and
``::layer_norm_bwd`` on CPU tensors: the forward is the eager chain bit for
bit (and ``models/vit.py`` ``layer_norm`` on the CPU the chain as it was),
the backward agrees with autograd through the chain and with ``jax.grad``
of the JAX package's ``layer_norm``; fakes, opcheck, the CUDA kernels'
registration and entry points, the routing of ``layer_norm()`` inside its
``bvc::layer_norm`` range, what autograd saves, and bf16 serving artifacts
holding two operators a block.  The kernels themselves run in
``chip_smoke.py`` on the card."""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.models.vit import layer_norm as jax_layer_norm
from bvc_tpu_torch.models import vit
from bvc_tpu_torch.models.jepa import JEPAEncoder
from bvc_tpu_torch.models.videomae import VideoMAEEncoder
from bvc_tpu_torch.ops import _build
from bvc_tpu_torch.ops import layer_norm as ln
from bvc_tpu_torch.ops.layer_norm import (LAYER_NORM_MAX_WIDTH, layer_norm_bwd_op,
                                          layer_norm_bwd_ref, layer_norm_chain, layer_norm_cuda,
                                          layer_norm_op, layer_norm_route)
from bvc_tpu_torch.serving.export import export_embed, kernel_ops, load_artifact, save_artifact
from bvc_tpu_torch.utils.config import ModelConfig

EPS = (1e-12, 1e-6, 1e-5)


def _inputs(dtype: torch.dtype, affine: bool, seed: int = 0, shape=(3, 7, 64)):
    """x (normal of scale 2, each row shifted by a normal of scale 4, a
    constant row first), dy (normal) in ``dtype``, f32 weight and bias (or
    None)."""
    rng = np.random.default_rng(seed)
    x = 2 * rng.standard_normal(shape) + 4 * rng.standard_normal(shape[:-1] + (1,))
    x.reshape(-1, shape[-1])[0] = 1.5
    dy = rng.standard_normal(shape)
    w = b = None
    if affine:
        w = torch.from_numpy((1 + 0.5 * rng.standard_normal(shape[-1])).astype(np.float32))
        b = torch.from_numpy((0.5 * rng.standard_normal(shape[-1])).astype(np.float32))
    return (torch.from_numpy(x.astype(np.float32)).to(dtype),
            torch.from_numpy(dy.astype(np.float32)).to(dtype), w, b)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _old_chain(x, weight, bias, eps):
    """``models/vit.py`` ``layer_norm`` as it was before the operator."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight + bias
    return y.to(x.dtype)


def _grads(fn, x, dy, w, b):
    leaves = [t.clone().requires_grad_() for t in (x, w, b) if t is not None]
    xr, *params = leaves
    fn(xr, *(params or (None, None))).backward(dy)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_forward_is_the_eager_chain_bit_for_bit(dtype, affine, eps):
    x, _, w, b = _inputs(dtype, affine, seed=int(1e6 * eps) % 97)
    y, mean, rstd = layer_norm_op(x, w, b, eps)
    want = layer_norm_chain(x, w, b, eps)
    assert y.dtype == dtype and y.shape == x.shape and y.is_contiguous()
    assert torch.equal(_bits(y), _bits(want))
    assert torch.equal(_bits(want), _bits(_old_chain(x, w, b, eps)))
    xf = x.float()
    assert mean.dtype == rstd.dtype == torch.float32 and mean.shape == rstd.shape == (21,)
    assert torch.equal(mean, xf.mean(-1).reshape(-1))
    assert torch.equal(rstd, torch.rsqrt((xf - xf.mean(-1, keepdim=True)).square().mean(-1)
                                         + eps).reshape(-1))
    xt = x.transpose(0, 1)  # strided: y contiguous, the same values
    assert torch.equal(_bits(layer_norm_op(xt, w, b, eps)[0]),
                       _bits(layer_norm_chain(xt, w, b, eps).contiguous()))


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_vit_layer_norm_on_the_cpu_is_the_old_chain(dtype, affine):
    """Forward and every gradient bit for bit the chain as it was: the CPU
    route did not move."""
    x, dy, w, b = _inputs(dtype, affine, seed=5)
    assert torch.equal(_bits(vit.layer_norm(x, w, b, 1e-6)), _bits(_old_chain(x, w, b, 1e-6)))
    got = _grads(lambda *a: vit.layer_norm(*a, 1e-6), x, dy, w, b)
    want = _grads(lambda *a: _old_chain(*a, 1e-6), x, dy, w, b)
    for g, h in zip(got, want):
        assert torch.equal(_bits(g), _bits(h))


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_agrees_with_autograd_through_the_chain(dtype, affine):
    """dx within one bf16 ulp (bf16) or 1e-5 of its largest (f32); dweight
    and dbias within 1e-5 of their largest: the closed form rounds in
    another order than autograd's nodes."""
    x, dy, w, b = _inputs(dtype, affine, seed=1)
    got = _grads(lambda *a: layer_norm_op(*a, 1e-6)[0], x, dy, w, b)
    want = _grads(lambda *a: layer_norm_chain(*a, 1e-6), x, dy, w, b)
    dx, dx_want = got[0].float(), want[0].float()
    if dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(dx_want.abs().clamp(min=1e-30))) - 7)
        assert bool(((dx - dx_want).abs() <= ulp).all())
    else:
        torch.testing.assert_close(dx, dx_want, rtol=0, atol=1e-5 * dx_want.abs().max().item())
    for g, h in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, h, rtol=0, atol=1e-5 * h.abs().max().item())
    assert got[0].dtype == dtype


def test_backward_matches_jax_grad():
    x, dy, w, b = _inputs(torch.float32, True, seed=2)
    _, mean, rstd = layer_norm_op(x, w, b, 1e-6)

    def loss(xj, scale, bias):
        return jnp.sum(jax_layer_norm(xj, {"scale": scale, "bias": bias}, 1e-6)
                       * jnp.asarray(dy.numpy()))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t.numpy()) for t in (x, w, b)))
    got = layer_norm_bwd_ref(dy, x, w, mean, rstd)
    for g, h in zip(got, want):
        h = np.asarray(h)
        np.testing.assert_allclose(g.numpy(), h, rtol=0, atol=2e-5 * np.abs(h).max())
    dx, dw, db = layer_norm_bwd_op(dy, x, w, mean, rstd)
    assert torch.equal(dx, got[0]) and torch.equal(dw, got[1]) and torch.equal(db, got[2])


def test_unit_affine_backward_has_no_parameter_gradients():
    x, dy, _, _ = _inputs(torch.bfloat16, False, seed=3)
    _, mean, rstd = layer_norm_op(x, None, None, 1e-5)
    dx, dw, db = layer_norm_bwd_op(dy, x, None, mean, rstd)
    assert dx.dtype == torch.bfloat16 and dx.shape == x.shape and dw is None and db is None


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_opcheck(dtype, affine):
    x, dy, w, b = _inputs(dtype, affine, seed=4, shape=(2, 3, 16))
    params = [] if w is None else [w.requires_grad_(), b.requires_grad_()]
    torch.library.opcheck(layer_norm_op, (x.requires_grad_(), *(params or (None, None)), 1e-6))
    _, mean, rstd = layer_norm_op(x.detach(), w, b, 1e-6)
    torch.library.opcheck(layer_norm_bwd_op, (dy, x.detach(), None if w is None else w.detach(),
                                              mean, rstd))


def test_fakes_give_shapes_and_dtypes_and_hold_the_kernels_limits():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.bfloat16),
                              ("cpu", torch.float32)):
            x = torch.empty((2, 5, 24), dtype=dtype, device=device).transpose(0, 1)
            w = torch.empty(24, device=device)
            for weight in (w, None):
                y, mean, rstd = layer_norm_op(x, weight, weight, 1e-6)
                assert y.shape == (5, 2, 24) and y.dtype == dtype and y.is_contiguous()
                assert mean.shape == rstd.shape == (10,)
                assert mean.dtype == rstd.dtype == torch.float32
                assert y.device.type == mean.device.type == device
                dx, dw, db = layer_norm_bwd_op(x, x, weight, mean, rstd)
                assert dx.shape == (5, 2, 24) and dx.dtype == dtype and dx.is_contiguous()
                if weight is None:
                    assert dw is None and db is None
                else:
                    assert dw.shape == db.shape == (24,) and dw.dtype == torch.float32
        for bad in (torch.empty((2, 24), dtype=torch.float16, device="cuda"),
                    torch.empty((2, 12), dtype=torch.bfloat16, device="cuda"),
                    torch.empty((2, LAYER_NORM_MAX_WIDTH + 8), dtype=torch.bfloat16,
                                device="cuda")):
            with pytest.raises(ValueError, match="CUDA bf16"):
                layer_norm_op(bad, None, None, 1e-6)
        x = torch.empty((2, 24), dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="weight must be f32"):
            layer_norm_op(x, torch.empty(16, device="cuda"), torch.empty(16, device="cuda"), 1e-6)
        with pytest.raises(ValueError, match="differ from x"):
            layer_norm_bwd_op(torch.empty((2, 16), dtype=torch.bfloat16, device="cuda"), x,
                              None, torch.empty(2, device="cuda"), torch.empty(2, device="cuda"))


def test_cuda_wrappers_refuse_cpu_tensors():
    x, dy, w, b = _inputs(torch.bfloat16, True)
    with pytest.raises(ValueError, match="CUDA bf16"):
        layer_norm_cuda(x, w, b, 1e-6)
    with pytest.raises(ValueError, match="CUDA bf16"):
        ln.layer_norm_bwd_cuda(dy, x, w, torch.zeros(21), torch.ones(21))


@pytest.mark.parametrize("device,dtype,width,route", [
    ("cuda", torch.bfloat16, 768, "kernel"), ("cuda", torch.bfloat16, 384, "kernel"),
    ("cuda", torch.bfloat16, 1408, "kernel"), ("cuda", torch.bfloat16, 8, "kernel"),
    ("cuda", torch.bfloat16, LAYER_NORM_MAX_WIDTH, "kernel"),
    ("cuda", torch.bfloat16, LAYER_NORM_MAX_WIDTH + 8, "chain"),
    ("cuda", torch.bfloat16, 12, "chain"), ("cuda", torch.bfloat16, 0, "chain"),
    ("cuda", torch.float32, 768, "chain"), ("cuda", torch.float16, 768, "chain"),
    ("cpu", torch.bfloat16, 768, "chain"), ("cpu", torch.float32, 768, "chain")])
def test_layer_norm_route(device, dtype, width, route):
    assert layer_norm_route(device, dtype, width) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_cpu_inputs_keep_the_chain_inside_the_range(dtype):
    from torch.profiler import ProfilerActivity, profile

    x, _, w, b = _inputs(dtype, True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = vit.layer_norm(x, w, b, 1e-6)
    names = [e.name for e in prof.events()]
    assert names.count("bvc::layer_norm") == 1
    assert "bvc_tpu_torch::layer_norm" not in names
    assert torch.equal(_bits(y), _bits(_old_chain(x, w, b, 1e-6)))


def test_the_operator_runs_inside_the_layer_norm_range(monkeypatch):
    """With the route forced to the kernel on the CPU, the operator (whose
    CPU side is the chain) runs inside ``bvc::layer_norm``, and its
    gradient is the backward operator."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(ln, "layer_norm_route", lambda *a: "kernel")
    x, dy, w, b = _inputs(torch.bfloat16, True)
    x.requires_grad_()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = vit.layer_norm(x, w, b, 1e-6)
        y.backward(dy)
    events = {e.name: e.time_range for e in prof.events()
              if e.name in ("bvc::layer_norm", "bvc_tpu_torch::layer_norm")}
    outer, inner = events["bvc::layer_norm"], events["bvc_tpu_torch::layer_norm"]
    assert outer.start <= inner.start and inner.end <= outer.end
    assert "bvc_tpu_torch::layer_norm_bwd" in {e.name for e in prof.events()}
    assert torch.equal(_bits(y), _bits(_old_chain(x.detach(), w, b, 1e-6)))


@pytest.mark.parametrize("affine", [True, False])
def test_the_operator_saves_only_x_and_the_row_vectors(monkeypatch, affine):
    """The operator's gradient keeps ``x`` (bf16) and the f32 ``mean`` and
    ``rstd`` ``[rows]`` (and the weight, a parameter); the chain keeps f32
    tensors of ``x``'s shape."""
    x, dy, w, b = _inputs(torch.bfloat16, affine)
    params = [] if w is None else [w.requires_grad_(), b.requires_grad_()]

    def saved_by(fn):
        saved = []
        xr = x.clone().requires_grad_()
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                      lambda t: t):
            y = fn(xr, *(params or (None, None)), 1e-6)
        y.backward(dy)
        return saved, xr.grad

    chain_saved, chain_dx = saved_by(vit.layer_norm)
    assert any(t.dtype == torch.float32 and t.shape == x.shape for t in chain_saved)
    monkeypatch.setattr(ln, "layer_norm_route", lambda *a: "kernel")
    saved, dx = saved_by(vit.layer_norm)
    activations = [t for t in saved if not any(t is p for p in params)]
    assert len(activations) == 3 and len(saved) == 3 + bool(params)
    assert activations[0].dtype == torch.bfloat16 and activations[0].shape == x.shape
    assert all(t.dtype == torch.float32 and t.shape == (21,) for t in activations[1:])
    assert dx.dtype == torch.bfloat16 and dx.shape == chain_dx.shape


@pytest.mark.parametrize("op", ["layer_norm", "layer_norm_bwd"])
def test_cuda_kernel_registered(op):
    name = f"bvc_tpu_torch::{op}"
    for key in ("CPU", "CUDA", "Meta"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key), (op, key)


def test_kernel_entry_points_and_width_limit():
    """``csrc/layer_norm.cu`` has the typed entry points and the widest row
    :data:`LAYER_NORM_MAX_WIDTH` names."""
    assert ln._SIGNATURES == {"bvc_layer_norm_fwd": (6, 2, 1), "bvc_layer_norm_bwd": (9, 3)}
    src = (_build.CSRC_DIR / "layer_norm.cu").read_text()
    for entry in ln._SIGNATURES:
        assert f'extern "C" int {entry}(' in src
    found = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(found["kThreads"]) // 32 * 32 * int(found["kMaxPieces"]) * int(found["kVec"])
            == LAYER_NORM_MAX_WIDTH)
    assert ln.OP_LIBRARIES == {"layer_norm": "layer_norm", "layer_norm_bwd": "layer_norm"}


def test_load_library_types_double_arguments(monkeypatch, tmp_path):
    """Entry points of ``(pointers, longs, doubles)`` get ``double`` after
    the ``long long`` arguments; two-number signatures none."""

    class Lib:
        def __init__(self, path):
            self.bvc_a = type("Fn", (), {})()
            self.bvc_b = type("Fn", (), {})()

    monkeypatch.setattr(_build, "build_all", lambda names: {names[0]: tmp_path / "lib.so"})
    monkeypatch.setattr(_build.ctypes, "CDLL", Lib)
    lib = _build.load_library("x", {"bvc_a": (2, 1, 1), "bvc_b": (1, 2)})
    c = ctypes
    assert lib.bvc_a.argtypes == [c.c_void_p, c.c_void_p, c.c_longlong, c.c_double, c.c_void_p]
    assert lib.bvc_b.argtypes == [c.c_void_p, c.c_longlong, c.c_longlong, c.c_void_p]
    assert lib.bvc_a.restype is c.c_int


@pytest.mark.parametrize("family", ["videomae", "jepa"])
def test_bf16_artifact_holds_two_layer_norms_a_block(tmp_path, monkeypatch, family):
    """Exported with the kernel's route (as on the card), a bf16 artifact
    holds two ``layer_norm`` nodes a block and the JEPA encoder's final
    norm (VideoMAE's pooled norm of f32 features keeps the chain); it
    reloads and runs, equal to the eager model bit for bit (the operator's
    CPU side is the chain)."""
    cfg = ModelConfig(image_size=32, patch_size=8, num_frames=4, tubelet_size=2,
                      hidden_size=32, depth=3, num_heads=4, dtype="bfloat16")
    model = VideoMAEEncoder(cfg) if family == "videomae" else JEPAEncoder(cfg)
    monkeypatch.setattr(ln, "layer_norm_route", lambda device, dtype, width: (
        "kernel" if dtype == torch.bfloat16 else "chain"))
    exported, meta = export_embed(family, model, cfg, device="cpu")
    monkeypatch.undo()
    assert kernel_ops(exported) == {"gelu_poly": cfg.depth,
                                    "layer_norm": 2 * cfg.depth + (family == "jepa")}
    fn = load_artifact(save_artifact(tmp_path / "port", exported, meta), device="cpu")
    video = np.random.default_rng(6).integers(0, 256, (2, 4, 32, 32, 3), dtype=np.uint8)
    with torch.no_grad():
        want = model.eval().embed(torch.from_numpy(video)).float().numpy()
    np.testing.assert_array_equal(fn(video), want)
