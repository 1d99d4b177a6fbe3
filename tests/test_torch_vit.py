"""The port's transformer block and stack against ``bvc_tpu.models.vit``
in f32 (1e-5: the two differ only in summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.models.vit import block_apply, init_blocks, run_blocks
from bvc_tpu_torch.models.vit import Block, Blocks

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
