"""The port's VideoMAE pretraining model against ``bvc_tpu.models.videomae``
on the same weights (carried by ``convert``), video and mask, in f32.

Tolerances: targets, predictions and the loss to 1e-5 (f32, the two sides
differ only in summation order); gradients to 1e-4 of each tensor's largest
entry, since they pass through every layer's backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.masks.tube import mask_partition as jax_mask_partition
from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu_torch.masks.tube import mask_partition
from bvc_tpu_torch.models.convert import (videomae_from_jax_params,
                                          videomae_pretrain_from_jax_params)
from bvc_tpu_torch.models.videomae import (VideoMAEEncoder, VideoMAEPretrain,
                                           normalize_on_device, patch_targets)
from bvc_tpu_torch.utils.config import ModelConfig

TINY = dict(image_size=32, patch_size=8, num_frames=4, tubelet_size=2,
            hidden_size=64, depth=2, num_heads=2, decoder_hidden_size=32,
            decoder_depth=1, decoder_num_heads=2, dtype="float32")
TOL = 1e-5
GRAD_TOL = 1e-4


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


def _tube_masks(B, grid, ratio, seed):
    """``[B, T*H*W]`` tube masks from numpy, and the visible count."""
    t, h, w = grid
    rng = np.random.default_rng(seed)
    frames = np.zeros((B, h * w), bool)
    for b in range(B):
        frames[b, rng.permutation(h * w)[:int(ratio * h * w)]] = True
    return np.tile(frames, (1, t)), t * h * w - t * int(ratio * h * w)


def _setup(seed=0, B=3):
    jcfg = JaxModelConfig(**TINY)
    tree = _jax_params(jcfg, seed)
    model = VideoMAEPretrain(ModelConfig(**TINY))
    model.load_state_dict(videomae_pretrain_from_jax_params(tree, model.cfg))
    clips = np.random.default_rng(seed + 1).integers(
        0, 256, (B, 4, 32, 32, 3), dtype=np.uint8)
    mask, num_visible = _tube_masks(B, (2, 4, 4), 0.75, seed + 2)
    return jcfg, tree, model, clips, mask, num_visible


def test_patch_targets_match_jax():
    jcfg = JaxModelConfig(**TINY)
    clips = np.random.default_rng(0).integers(0, 256, (2, 4, 32, 32, 3), dtype=np.uint8)
    video = np.array(jax_videomae.normalize_on_device(jnp.asarray(clips)))
    idx = np.stack([np.sort(np.random.default_rng(s).permutation(jcfg.seq_len)[:5])
                    for s in range(2)])
    for sel in (None, idx):
        ref = np.asarray(jax_videomae.patch_targets(
            jnp.asarray(video), jcfg, None if sel is None else jnp.asarray(sel)))
        out = patch_targets(torch.from_numpy(video), ModelConfig(**TINY),
                            None if sel is None else torch.from_numpy(sel))
        assert out.shape == ref.shape and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def test_decode_masked_matches_jax():
    jcfg, tree, model, clips, mask, num_visible = _setup(seed=1)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    video = jax_videomae.normalize_on_device(jnp.asarray(clips))
    vis, msk = jax_mask_partition(jnp.asarray(mask), num_visible)
    encoded = jax_videomae.encode_visible(params, video, vis, jcfg)
    ref = np.asarray(jax_videomae.decode_masked(params, encoded, vis, msk, jcfg))
    with torch.no_grad():
        tvis, tmsk = mask_partition(torch.from_numpy(mask), num_visible)
        enc = model.encoder.encode_visible(normalize_on_device(torch.from_numpy(clips)), tvis)
        out = model.decode_masked(enc, tvis, tmsk).numpy()
    assert out.shape == (3, mask.shape[1] - num_visible, 2 * 8 * 8 * 3)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("attn_impl", ["auto", "flash"])
def test_pretrain_loss_matches_jax(attn_impl):
    jcfg, tree, model, clips, mask, num_visible = _setup(seed=2)
    ref, _ = jax_videomae.pretrain_loss(jax.tree_util.tree_map(jnp.asarray, tree),
                                        jnp.asarray(clips), jnp.asarray(mask), jcfg,
                                        num_visible)
    with torch.no_grad():
        loss = model.pretrain_loss(torch.from_numpy(clips), torch.from_numpy(mask),
                                   num_visible, attn_impl)
    assert loss.shape == () and loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(ref), rtol=TOL, atol=TOL)


def test_pretrain_loss_grads_match_jax():
    jcfg, tree, model, clips, mask, num_visible = _setup(seed=3)
    grads = jax.grad(lambda p: jax_videomae.pretrain_loss(
        p, jnp.asarray(clips), jnp.asarray(mask), jcfg, num_visible)[0])(
        jax.tree_util.tree_map(jnp.asarray, tree))
    # the converter is linear in the leaves, so it carries gradients too
    ref = videomae_pretrain_from_jax_params(jax.tree_util.tree_map(np.array, grads),
                                            model.cfg)
    model.pretrain_loss(torch.from_numpy(clips), torch.from_numpy(mask),
                        num_visible, "flash").backward()
    for name, p in model.named_parameters():
        scale = ref[name].abs().max().item()
        assert scale > 0, name
        err = (p.grad - ref[name]).abs().max().item()
        assert err <= GRAD_TOL * scale, (name, err, scale)


def test_convert_fills_every_parameter():
    jcfg = JaxModelConfig(**TINY)
    tree = _jax_params(jcfg, seed=4)
    cfg = ModelConfig(**TINY)
    sd = videomae_pretrain_from_jax_params(tree, cfg)
    model = VideoMAEPretrain(cfg)
    assert sd.keys() == dict(model.named_parameters()).keys()
    model.load_state_dict(sd)  # strict: every key, no more
    assert torch.equal(model.mask_token, torch.from_numpy(tree["mask_token"]))
    assert torch.equal(model.enc_to_dec.weight, torch.from_numpy(tree["enc_to_dec"]["kernel"].T))
    assert torch.equal(model.decoder.layers[0].fc1.bias,
                       torch.from_numpy(tree["decoder"]["mlp"]["fc1"]["bias"][0]))
    assert torch.equal(model.decoder_norm.weight,
                       torch.from_numpy(tree["decoder_norm"]["scale"]))
    # the encoder's entries are those of the encoder-only conversion
    enc = videomae_from_jax_params(tree, cfg)
    assert all(torch.equal(sd["encoder." + k], v) for k, v in enc.items())


def test_seeded_init_matches_the_encoder_and_is_deterministic():
    cfg = ModelConfig(**TINY)
    a, b = VideoMAEPretrain(cfg, seed=5), VideoMAEPretrain(cfg, seed=5)
    enc = VideoMAEEncoder(cfg, seed=5).state_dict()
    assert all(torch.equal(a.encoder.state_dict()[k], v) for k, v in enc.items())
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert a.mask_token.shape == (1, 1, TINY["decoder_hidden_size"])
    assert a.enc_to_dec.bias is None
    assert torch.equal(a.decoder_norm.weight, torch.ones(TINY["decoder_hidden_size"]))
    assert 0 < a.mask_token.abs().max() <= 2 * cfg.init_std
