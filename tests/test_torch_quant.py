"""The port's W8A8 pieces against the JAX package: weight quantization
(``bvc_tpu_torch.ops.quant`` against ``bvc_tpu.ops.quant``), the plain
qdense, the plain int8 and bf16 products against numpy and against the
int8 probe's two Pallas kernel bodies in interpret mode, block selection
and the ``quantize`` option's rejections."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bvc_tpu.models.vit import init_blocks
from bvc_tpu.ops import quant as jax_quant
from bvc_tpu_torch.evalbench.extract import _check_quantize, make_embed_fn, untrained_embed_fn
from bvc_tpu_torch.models.convert import _blocks
from bvc_tpu_torch.models.vit import Blocks
from bvc_tpu_torch.ops.gemm import (bf16_matmul_cuda, bf16_matmul_ref, int8_matmul,
                                    int8_matmul_cuda, int8_matmul_ref)
from bvc_tpu_torch.ops.quant import (ALL_MATMULS, EXPANSION_MATMULS, QuantLinear, qdense,
                                     qdense_ref, quantize_blocks, quantize_linear,
                                     quantize_tokens)
from bvc_tpu_torch.utils.config import ModelConfig


def _linear(kernel: np.ndarray, bias: np.ndarray | None) -> torch.nn.Linear:
    """An ``nn.Linear`` holding a JAX ``[Din, Dout]`` kernel."""
    layer = torch.nn.Linear(*kernel.shape, bias=bias is not None)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(kernel.T.copy()))
        if bias is not None:
            layer.bias.copy_(torch.from_numpy(bias))
    return layer


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("din,dout", [(64, 128), (768, 2304)])
def test_quantize_linear_bit_identical_to_jax(din, dout):
    rng = np.random.default_rng(din)
    kernel = (rng.standard_normal((din, dout)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(dout) * 0.01).astype(np.float32)
    theirs = jax_quant.quantize_linear({"kernel": kernel, "bias": bias})
    ours = quantize_linear(_linear(kernel, bias))
    assert ours.weight_q.dtype == torch.int8 and ours.weight_q.shape == (dout, din)
    np.testing.assert_array_equal(ours.weight_q.numpy(), np.asarray(theirs["kernel_q"]).T)
    np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(theirs["scale"]))
    np.testing.assert_array_equal(ours.bias.numpy(), bias)


def test_stacked_tree_through_the_converter():
    # one stacked [3, 16, 24] linear, layer by layer, as test_quant.py shapes it
    rng = np.random.default_rng(2)
    kernel = rng.standard_normal((3, 16, 24)).astype(np.float32)
    theirs = jax_quant.quantize_linear({"kernel": kernel})
    for i in range(3):
        ours = quantize_linear(_linear(kernel[i], None))
        assert ours.bias is None
        np.testing.assert_array_equal(ours.weight_q.numpy(),
                                      np.asarray(theirs["kernel_q"][i]).T)
        np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(theirs["scale"][i]))
        assert (ours.weight_q.int().abs().amax(dim=1) == 127).all()

    # a stacked block tree: JAX's quantized tree read by the converter equals
    # the port's quantization of the converted f32 tree, leaf for leaf
    tree = jax.tree_util.tree_map(np.asarray, init_blocks(jax.random.PRNGKey(0), 3, 16))
    qtree = jax.tree_util.tree_map(np.asarray, jax_quant.quantize_blocks(tree, ALL_MATMULS))
    blocks = Blocks(3, 16, 2)
    blocks.load_state_dict(_blocks(tree, 3, ""))
    quantize_blocks(blocks, ALL_MATMULS)
    ours = blocks.state_dict()
    read = _blocks(qtree, 3, "")
    assert set(read) == set(ours)
    for name, x in read.items():
        assert x.dtype == ours[name].dtype, name
        assert torch.equal(x, ours[name]), name
    q = np.asarray(qtree["attn"]["qkv"]["kernel_q"], np.int32)
    assert (np.abs(q).max(axis=1) == 127).all()


def _jax_xq(x: np.ndarray) -> np.ndarray:
    """JAX qdense's activation quantization (ops/quant.py:124-127)."""
    xf = jnp.asarray(x).astype(jnp.float32)
    xscale = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12) / 127.0
    return np.asarray(jnp.clip(jnp.round(xf / xscale), -127.0, 127.0).astype(jnp.int8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("xshape,dout", [((8, 64), 128), ((2, 5, 768), 2304)])
def test_qdense_matches_jax(dtype, with_bias, xshape, dout):
    rng = np.random.default_rng(len(xshape) + dout)
    din = xshape[-1]
    x32 = (rng.standard_normal(xshape) * 2).astype(np.float32)
    kernel = (rng.standard_normal((din, dout)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(dout) * 0.01).astype(np.float32) if with_bias else None
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(x32).astype(jdtype)
    xt = torch.from_numpy(x32).to(tdtype)
    params = {"kernel": kernel, **({"bias": bias} if with_bias else {})}
    ref = np.asarray(jax_quant.qdense(xj, jax_quant.quantize_linear(params), jdtype),
                     np.float32)
    layer = quantize_linear(_linear(kernel, bias))

    xq, xscale = quantize_tokens(xt)
    assert xscale.shape == (*xshape[:-1], 1)
    mismatches = int((xq.numpy() != _jax_xq(np.asarray(xj))).sum())
    assert mismatches == 0  # read: 0 at every case

    out = qdense_ref(xt, layer)
    assert out.dtype == tdtype and out.shape == (*xshape[:-1], dout)
    assert torch.equal(qdense(xt, layer), out)  # CPU tensors take the plain version
    got = out.float().numpy()
    err = np.abs(got - ref)
    if dtype == "float32":
        # the same f32 steps in the same order: read max err 0.0
        assert err.max() <= 1e-6 * np.abs(ref).max(), err.max()
    else:
        # one bf16 ulp of the reference: read max err 0.0
        assert (err <= _bf16_ulp(ref)).all(), err.max()


def test_extreme_rows_stay_finite():
    # as tests/test_quant.py: all-zero rows (scale floor) give exactly 0,
    # rows at 1e6 (clip) stay finite
    x = torch.cat([torch.zeros(2, 16), torch.full((2, 16), 1e6)])
    layer = quantize_linear(_linear(np.eye(16, dtype=np.float32), None))
    out = qdense_ref(x, layer, torch.float32)
    assert torch.isfinite(out).all()
    assert out[:2].abs().max().item() == 0.0
    ref = np.asarray(jax_quant.qdense(jnp.asarray(x.numpy()),
                                      jax_quant.quantize_linear({"kernel": np.eye(16,
                                                                 dtype=np.float32)}),
                                      jnp.float32))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("k", [32, 768, 3072])
def test_int8_matmul_ref_exact(k):
    rng = np.random.default_rng(k)
    a = rng.integers(-128, 128, (37, k), dtype=np.int8)
    b = rng.integers(-128, 128, (29, k), dtype=np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64).T
    got = int8_matmul_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(int8_matmul(torch.from_numpy(a), torch.from_numpy(b)), got)


def _probe_call(body, m, k, n, out_dtype):
    """The probe's ungridded ``pl.pallas_call`` (tools/probe_pallas_int8.py:53),
    run in interpret mode."""
    return pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct((m, n), out_dtype),
                          interpret=True)


def _kern_i8(a_ref, b_ref, o_ref):  # tools/probe_pallas_int8.py:37-40
    o_ref[...] = jax.lax.dot_general(
        a_ref[...], b_ref[...], (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)


def _kern_bf16(a_ref, b_ref, o_ref):  # tools/probe_pallas_int8.py:42-45
    o_ref[...] = jax.lax.dot_general(
        a_ref[...], b_ref[...], (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)


def test_plain_products_match_the_probe_kernels():
    m, k, n = 64, 96, 40
    rng = np.random.default_rng(0)
    a8 = rng.integers(-127, 127, (m, k), dtype=np.int8)  # the probe's draws
    b8 = rng.integers(-127, 127, (k, n), dtype=np.int8)  # [K, N], as the probe
    want = np.asarray(_probe_call(_kern_i8, m, k, n, jnp.int32)(jnp.asarray(a8),
                                                                 jnp.asarray(b8)))
    got = int8_matmul_ref(torch.from_numpy(a8), torch.from_numpy(b8.T.copy()))
    np.testing.assert_array_equal(got.numpy(), want)

    # kern_bf16 on the probe's integer-valued inputs: exact (partial sums < 2^24)
    bf = _probe_call(_kern_bf16, m, k, n, jnp.float32)
    a16, b16 = torch.from_numpy(a8).bfloat16(), torch.from_numpy(b8.T.copy()).bfloat16()
    want16 = np.asarray(bf(jnp.asarray(a8, jnp.bfloat16), jnp.asarray(b8, jnp.bfloat16)))
    np.testing.assert_array_equal(bf16_matmul_ref(a16, b16).numpy(), want16)
    np.testing.assert_array_equal(want16, want.astype(np.float32))
    # on normal inputs: f32 sums in another order, read max err 1.3e-7 of max|ref|
    an = rng.standard_normal((m, k)).astype(np.float32)
    bn = rng.standard_normal((k, n)).astype(np.float32)
    aj, bj = jnp.asarray(an, jnp.bfloat16), jnp.asarray(bn, jnp.bfloat16)
    want_n = np.asarray(bf(aj, bj))
    got_n = bf16_matmul_ref(torch.from_numpy(an).bfloat16(),
                            torch.from_numpy(bn.T.copy()).bfloat16()).numpy()
    assert np.abs(got_n - want_n).max() <= 1e-5 * np.abs(want_n).max()


def test_kernel_wrappers_refuse_cpu_tensors():
    a = torch.zeros(4, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        int8_matmul_cuda(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        bf16_matmul_cuda(a.bfloat16(), a.bfloat16())


def test_quantize_blocks_selection_and_errors():
    blocks = Blocks(2, 32, 4)
    ln1 = blocks.layers[0].ln1
    assert quantize_blocks(blocks) is blocks
    for layer in blocks.layers:
        assert isinstance(layer.qkv, QuantLinear) and isinstance(layer.fc1, QuantLinear)
        assert isinstance(layer.proj, torch.nn.Linear) and isinstance(layer.fc2, torch.nn.Linear)
    assert blocks.layers[0].ln1 is ln1  # LayerNorms untouched
    assert EXPANSION_MATMULS == jax_quant.EXPANSION_MATMULS
    assert ALL_MATMULS == jax_quant.ALL_MATMULS
    quantize_blocks(blocks, ALL_MATMULS)  # already-quantized layers stay as they are
    assert all(isinstance(getattr(layer, a), QuantLinear) for layer in blocks.layers
               for a in ("qkv", "proj", "fc1", "fc2"))
    with pytest.raises(ValueError, match="unknown block matmuls"):
        quantize_blocks(Blocks(1, 32, 4), ("attn.qkv", "mlp.fc3"))


def test_check_quantize_rejections(tmp_path):
    assert _check_quantize("videomae", "none") is False
    assert _check_quantize("videomae", "") is False
    assert _check_quantize("videomae", None) is False
    assert _check_quantize("jepa", "int8") is True
    with pytest.raises(ValueError, match="resnet"):
        _check_quantize("simclr", "int8")
    with pytest.raises(ValueError, match="quantize mode"):
        _check_quantize("videomae", "fp8")
    # the entry points check the option before anything else: SimCLR with
    # int8 names resnet before SimCLR's NotImplementedError
    cfg = ModelConfig(image_size=32, patch_size=8, num_frames=4, hidden_size=16, depth=1,
                      num_heads=1)
    with pytest.raises(ValueError, match="resnet"):
        untrained_embed_fn("simclr", cfg, device="cpu", quantize="int8")
    with pytest.raises(ValueError, match="resnet"):
        make_embed_fn("simclr", str(tmp_path / "x.pth.tar"), cfg, device="cpu",
                      quantize="int8")
    with pytest.raises(ValueError, match="quantize mode"):
        untrained_embed_fn("videomae", cfg, device="cpu", quantize="int4")
