"""The slice as a whole: JAX VideoMAE params carried into the port, and the
port's embedding against ``bvc_tpu.models.videomae.embed`` on the same
uint8 clips.

Tolerances: f32, max abs 1e-4 (the embeddings are unit-LN, O(1)); bf16,
cosine >= 0.999 per row, because the two frameworks round bf16 at different
places (the port fuses the bias into the linear product, XLA adds it after
rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.models.torch_interop import videomae_to_hf_state_dict
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu_torch.models.convert import (videomae_from_hf_state_dict,
                                          videomae_from_jax_params)
from bvc_tpu_torch.models.videomae import VideoMAEEncoder, normalize_on_device
from bvc_tpu_torch.utils.config import ModelConfig

SMALL = dict(image_size=32, patch_size=8, num_frames=4, tubelet_size=2,
             hidden_size=32, depth=2, num_heads=2, mlp_ratio=2.0,
             decoder_hidden_size=16, decoder_depth=1, decoder_num_heads=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(cfg, seed=0):
    """JAX init, every leaf perturbed (non-trivial biases and affines)."""
    tree = jax_videomae.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32), tree)


def _clips(cfg, B=3, seed=1):
    return np.random.default_rng(seed).integers(
        0, 256, (B, cfg.num_frames, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)


def _port(cfg, tree):
    model = VideoMAEEncoder(ModelConfig(**{**SMALL, "dtype": cfg.dtype}))
    model.load_state_dict(videomae_from_jax_params(tree, model.cfg))
    return model.eval()


def _both(dtype):
    jcfg = JaxModelConfig(**SMALL, dtype=dtype)
    tree = _jax_params(jcfg)
    clips = _clips(jcfg)
    ref = np.asarray(jax.jit(lambda p, v: jax_videomae.embed(p, v, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(clips)))
    return jcfg, tree, clips, ref


def test_embed_f32_matches_jax():
    jcfg, tree, clips, ref = _both("float32")
    model = _port(jcfg, tree)
    with torch.no_grad():
        out = model.embed(torch.from_numpy(clips)).numpy()
        flash = model.embed(torch.from_numpy(clips), attn_impl="flash").numpy()
        plain = model.embed(torch.from_numpy(clips), attn_impl="xla").numpy()
    assert out.shape == (3, SMALL["hidden_size"]) and out.dtype == np.float32
    assert np.abs(out - ref).max() <= 1e-4
    # the kernel's plain version and the plain attention path agree
    np.testing.assert_allclose(flash, plain, rtol=1e-5, atol=1e-5)


def test_embed_bf16_cosine_to_jax():
    jcfg, tree, clips, ref = _both("bfloat16")
    model = _port(jcfg, tree)
    with torch.no_grad():
        out = model.embed(torch.from_numpy(clips)).numpy()
        flash = model.embed(torch.from_numpy(clips), attn_impl="flash").numpy()
    for emb in (out, flash):
        cos = (emb * ref).sum(1) / (np.linalg.norm(emb, axis=1) * np.linalg.norm(ref, axis=1))
        assert cos.min() >= 0.999, cos


def test_forward_features_and_encode_visible_match_jax():
    jcfg = JaxModelConfig(**SMALL, dtype="float32")
    tree = _jax_params(jcfg, seed=3)
    clips = _clips(jcfg, B=2, seed=4)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = np.asarray(jax_videomae.forward_features(params, jnp.asarray(clips), jcfg))
    model = _port(jcfg, tree)
    idx = np.stack([np.sort(np.random.default_rng(s).permutation(jcfg.seq_len)[:10])
                    for s in range(2)])
    video = jax_videomae.normalize_on_device(jnp.asarray(clips))
    ref_vis = np.asarray(jax_videomae.encode_visible(params, video, jnp.asarray(idx), jcfg))
    with torch.no_grad():
        out = model.forward_features(torch.from_numpy(clips)).numpy()
        vis = model.encode_visible(normalize_on_device(torch.from_numpy(clips)),
                                   torch.from_numpy(idx)).numpy()
    assert out.shape == (2, jcfg.seq_len, SMALL["hidden_size"])
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vis, ref_vis, rtol=1e-4, atol=1e-4)


def test_normalize_on_device_matches_jax():
    clips = _clips(JaxModelConfig(**SMALL), B=1)
    ref = np.asarray(jax_videomae.normalize_on_device(jnp.asarray(clips)))
    np.testing.assert_array_equal(normalize_on_device(torch.from_numpy(clips)).numpy(), ref)
    x = torch.randn(2, 3)
    assert normalize_on_device(x) is x


def test_hf_state_dict_matches_jax_conversion():
    # the HF layout has no k bias: its third of the fused qkv bias is zero,
    # and the rest is what the direct conversion gives
    jcfg = JaxModelConfig(**SMALL)
    tree = _jax_params(jcfg, seed=5)
    cfg = ModelConfig(**SMALL)
    direct = videomae_from_jax_params(tree, cfg)
    via_hf = videomae_from_hf_state_dict(videomae_to_hf_state_dict(tree, jcfg), cfg)
    assert direct.keys() == via_hf.keys()
    D = SMALL["hidden_size"]
    for key in direct:
        if key.endswith("qkv.bias"):
            assert torch.equal(via_hf[key][D:2 * D], torch.zeros(D))
            assert torch.equal(via_hf[key][:D], direct[key][:D])
            assert torch.equal(via_hf[key][2 * D:], direct[key][2 * D:])
        else:
            assert torch.equal(via_hf[key], direct[key]), key
    VideoMAEEncoder(cfg).load_state_dict(via_hf)  # strict: every key, no more


def test_architecture_other_than_base_raises():
    with pytest.raises(ValueError, match="only 'base'"):
        VideoMAEEncoder(ModelConfig(**SMALL, architecture="tiny"))


def test_seeded_init_is_deterministic():
    cfg = ModelConfig(**SMALL)
    a, b, c = VideoMAEEncoder(cfg, seed=0), VideoMAEEncoder(cfg, seed=0), VideoMAEEncoder(cfg, seed=1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["patch_embed.weight"], sc["patch_embed.weight"])
    assert torch.equal(sa["blocks.layers.0.qkv.bias"], torch.zeros(3 * SMALL["hidden_size"]))
