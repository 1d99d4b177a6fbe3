"""The port's transformer block and stack against ``bvc_tpu.models.vit``
in f32 (1e-5: the two differ only in summation order), and one block's
attention probabilities (``block_attention_probs``) in f32, bf16 and with a
W8A8 ``qkv``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.models.vit import block_apply, block_attention_probs as jax_attention_probs
from bvc_tpu.models.vit import init_blocks, run_blocks
from bvc_tpu.ops import quant as jax_quant
from bvc_tpu_torch.models.vit import Block, Blocks, block_attention_probs
from bvc_tpu_torch.ops.quant import qdense, quantize_linear

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_blocks(depth, dim, mlp_ratio=2.0, qkv_bias=True, seed=0):
    """Stacked JAX block params with every leaf perturbed, so biases and
    LayerNorm affines are not the trivial 0 / 1 of a fresh init."""
    tree = init_blocks(jax.random.PRNGKey(seed), depth, dim, mlp_ratio, qkv_bias)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, x.shape).astype(np.float32), tree)


def _layer_state(tree, i):
    """Layer ``i`` of a stacked JAX tree as a port ``Block`` state dict."""
    sd = {}
    for name in ("ln1", "ln2"):
        sd[f"{name}.weight"] = torch.from_numpy(tree[name]["scale"][i])
        sd[f"{name}.bias"] = torch.from_numpy(tree[name]["bias"][i])
    for name, p in (("qkv", tree["attn"]["qkv"]), ("proj", tree["attn"]["proj"]),
                    ("fc1", tree["mlp"]["fc1"]), ("fc2", tree["mlp"]["fc2"])):
        sd[f"{name}.weight"] = torch.from_numpy(p["kernel"][i].T.copy())
        if "bias" in p:
            sd[f"{name}.bias"] = torch.from_numpy(p["bias"][i])
    return sd


@pytest.mark.parametrize("qkv_bias", [True, False])
def test_block_matches_jax(qkv_bias):
    dim, heads = 32, 2
    tree = _jax_blocks(1, dim, qkv_bias=qkv_bias)
    block = Block(dim, heads, mlp_ratio=2.0, qkv_bias=qkv_bias)
    block.load_state_dict(_layer_state(tree, 0))
    x = np.random.default_rng(1).standard_normal((2, 20, dim)).astype(np.float32)
    layer = jax.tree_util.tree_map(lambda l: jnp.asarray(l[0]), tree)
    ref = np.asarray(block_apply(layer, jnp.asarray(x), heads, 1e-6))
    with torch.no_grad():
        out = block(torch.from_numpy(x)).numpy()
        flash = block(torch.from_numpy(x), attn_impl="flash").numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(flash, ref, rtol=TOL, atol=TOL)


def test_blocks_match_jax_run_blocks():
    depth, dim, heads = 2, 24, 3
    tree = _jax_blocks(depth, dim, seed=4)
    blocks = Blocks(depth, dim, heads, mlp_ratio=2.0)
    blocks.load_state_dict({f"layers.{i}.{k}": v for i in range(depth)
                            for k, v in _layer_state(tree, i).items()})
    x = np.random.default_rng(5).standard_normal((2, 18, dim)).astype(np.float32)
    ref = np.asarray(run_blocks(jax.tree_util.tree_map(jnp.asarray, tree),
                                jnp.asarray(x), heads, 1e-6))
    with torch.no_grad():
        out = blocks(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_block_bf16_activations_keep_f32_params():
    block = Block(64, 1, generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 10, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = block(x.to(torch.bfloat16))
        ref = block(x)
    assert out.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in block.parameters())
    torch.testing.assert_close(out.float(), ref, rtol=0.05, atol=0.05)


# bf16: the port adds the qkv bias inside the bf16 product, the JAX package
# after it, so an element of q or k may round one bf16 ulp apart (read:
# 1.1e-4 on probabilities)
PROBS_TOL = {"float32": TOL, "bfloat16": 1e-3, "int8": TOL}


@pytest.mark.parametrize("dtype", list(PROBS_TOL))
def test_block_attention_probs_matches_jax(dtype, monkeypatch):
    """``[B, h, N, N]`` f32 probabilities against JAX's, rows summing to 1
    (``test_vit_core.py``'s rtol 1e-5); ``int8``: the block's ``qkv``
    quantized on both sides (JAX's ``qdense``, the port's through
    ``qdense``)."""
    dim, heads = 32, 2
    tree = _jax_blocks(1, dim, seed=7)
    block = Block(dim, heads, mlp_ratio=2.0)
    block.load_state_dict(_layer_state(tree, 0))
    if dtype == "int8":
        tree = jax_quant.quantize_blocks(tree, ("attn.qkv",))
        block.qkv = quantize_linear(block.qkv)
        calls = []
        monkeypatch.setattr("bvc_tpu_torch.models.vit.qdense",
                            lambda *a: calls.append(1) or qdense(*a))
    xdtype = "float32" if dtype == "int8" else dtype
    x = np.random.default_rng(3).standard_normal((2, 20, dim)).astype(np.float32)
    layer = jax.tree_util.tree_map(lambda l: jnp.asarray(l[0]), tree)
    ref = np.asarray(jax_attention_probs(layer, jnp.asarray(x).astype(xdtype), heads))
    with torch.no_grad():
        out = block_attention_probs(block, torch.from_numpy(x).to(getattr(torch, xdtype)))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, heads, 20, 20)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=PROBS_TOL[dtype])
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, rtol=1e-5)
    if dtype == "int8":
        assert calls == [1]
