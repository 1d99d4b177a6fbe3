"""The port's ops, config and position table against the JAX package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.models.posenc import sinusoid_table_1d as jax_sinusoid
from bvc_tpu.models.vit import layer_norm as jax_layer_norm
from bvc_tpu.ops.gelu import gelu as jax_gelu
from bvc_tpu.ops.patchify import patchify_pixels as jax_patchify
from bvc_tpu.ops.patchify import tubelet_patchify as jax_tubelet_patchify
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu_torch.models.initializers import trunc_normal_
from bvc_tpu_torch.models.posenc import sinusoid_table_1d
from bvc_tpu_torch.models.vit import layer_norm
from bvc_tpu_torch.ops.gelu import GELU_ERF_POLY_COEF, gelu, gelu_poly
from bvc_tpu_torch.ops.patchify import patchify_pixels, tubelet_patchify
from bvc_tpu_torch.utils.config import ModelConfig
from torch_port_config import without_port_only


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bf16 (8 significant bits) at |x|; 0 at x = 0."""
    ax = np.abs(x.astype(np.float64))
    e = np.floor(np.log2(np.where(ax > 0, ax, 1.0)))
    return np.where(ax > 0, 2.0 ** (e - 7), 0.0)


def test_patchify_pixels_matches_jax():
    video = np.random.default_rng(0).standard_normal((2, 4, 16, 24, 3)).astype(np.float32)
    ref = np.asarray(jax_patchify(jnp.asarray(video), 2, 8))
    out = patchify_pixels(torch.from_numpy(video), 2, 8).numpy()
    assert out.shape == (2, 2 * 2 * 3, 3 * 2 * 8 * 8)
    np.testing.assert_array_equal(out, ref)


def test_tubelet_patchify_matches_jax():
    rng = np.random.default_rng(1)
    video = rng.standard_normal((2, 4, 16, 16, 3)).astype(np.float32)
    kernel = rng.standard_normal((3 * 2 * 8 * 8, 24)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    ref = np.asarray(jax_tubelet_patchify(jnp.asarray(video), jnp.asarray(kernel),
                                          jnp.asarray(bias), 2, 8, dtype=jnp.float32))
    out = tubelet_patchify(torch.from_numpy(video), torch.from_numpy(kernel.T.copy()),
                           torch.from_numpy(bias), 2, 8, dtype=torch.float32).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_gelu_poly_bf16_matches_jax_to_the_ulp():
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = np.asarray(jax_gelu(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    out = gelu(xb)  # 'auto' on bf16 is the polynomial
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    assert np.all(np.abs(out - ref) <= _bf16_ulp(np.maximum(np.abs(out), np.abs(ref))))
    np.testing.assert_array_equal(gelu_poly(xb).float().numpy(), out)


def test_gelu_exact_f32_matches_jax():
    x = np.linspace(-8, 8, 4001).astype(np.float32)
    ref = np.asarray(jax_gelu(jnp.asarray(x)))  # 'auto' on f32 is exact erf
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gelu(torch.from_numpy(x), "exact").numpy(), ref,
                               rtol=0, atol=1e-6)


def test_gelu_poly_f32_matches_jax():
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    ref = np.asarray(jax_gelu(jnp.asarray(x), impl="poly"))
    np.testing.assert_allclose(gelu(torch.from_numpy(x), "poly").numpy(), ref,
                               rtol=0, atol=1e-6)
    assert len(GELU_ERF_POLY_COEF) == 8
    with pytest.raises(ValueError):
        gelu(torch.zeros(2), "tanh")


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((2, 5, 48)) + 1).astype(np.float32)
    w, b = (rng.standard_normal(48).astype(np.float32) for _ in range(2))
    ref = np.asarray(jax_layer_norm(jnp.asarray(x), {"scale": jnp.asarray(w),
                                                     "bias": jnp.asarray(b)}, 1e-6))
    out = layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-6)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_layer_norm_keeps_dtype_with_f32_stats():
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    out = layer_norm(x, torch.ones(64), torch.zeros(64))
    assert out.dtype == torch.bfloat16
    ref = layer_norm(x.float(), None, None)
    torch.testing.assert_close(out.float(), ref.to(torch.bfloat16).float())


def test_sinusoid_table_matches_jax():
    np.testing.assert_array_equal(sinusoid_table_1d(1568, 768), jax_sinusoid(1568, 768))
    np.testing.assert_array_equal(sinusoid_table_1d(32, 24), jax_sinusoid(32, 24))


def test_model_config_matches_jax():
    ours = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxModelConfig)}
    assert without_port_only(ours, "model") == theirs
    for kw in ({}, {"image_size": 32, "patch_size": 8, "num_frames": 4}):
        assert ModelConfig(**kw).seq_len == JaxModelConfig(**kw).seq_len
        assert ModelConfig(**kw).tokens_per_frame == JaxModelConfig(**kw).tokens_per_frame
    assert ModelConfig().seq_len == 1568


def test_trunc_normal_is_seeded_and_truncated():
    a = trunc_normal_(torch.empty(20000), 0.02, torch.Generator().manual_seed(3))
    b = trunc_normal_(torch.empty(20000), 0.02, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert a.abs().max() <= 0.04 + 1e-7
    # std of a standard normal truncated at +-2 sigma is 0.8796
    assert abs(a.std().item() / 0.02 - 0.8796) < 0.02
