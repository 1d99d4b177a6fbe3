"""Activation checkpointing (``ModelConfig.remat``) and drop-path in the
port's models.

Tolerances: ``remat=True`` gives the same loss and gradients as
``remat=False`` exactly in f32 on the CPU (the recompute runs the same
operations on the same inputs); drop-path at rate 0 is the identity
exactly; at rate p with a given keep mask the port's ``drop_path`` and a
whole block equal ``bvc_tpu``'s ``drop_path`` and ``block_apply`` fed the
same mask, within 1e-6 (f32, max abs of O(1) activations) and exactly for
``drop_path`` in bf16.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.models import vit as jax_vit
from bvc_tpu_torch.masks.multiblock import mask_collate
from bvc_tpu_torch.masks.tube import tube_mask
from bvc_tpu_torch.models.convert import _blocks
from bvc_tpu_torch.models.jepa import JEPA
from bvc_tpu_torch.models.videomae import VideoMAEPretrain
from bvc_tpu_torch.models.vit import Blocks, drop_path
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_jepa_train_step
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig
from torch_tiny_runs import JEPA_MODEL, VIDEOMAE_MODEL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def test_videomae_remat_gives_the_same_gradients():
    clips = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 4, 32, 32, 3), dtype=np.uint8))
    mask = tube_mask(torch.Generator().manual_seed(1), 4, (2, 4, 4), 0.75)
    out = {}
    for remat in (False, True):
        model = VideoMAEPretrain(ModelConfig(**VIDEOMAE_MODEL, remat=remat), seed=0)
        assert model.encoder.blocks.remat == model.decoder.remat == remat
        loss = model.pretrain_loss(clips, mask, num_visible=8)
        loss.backward()
        out[remat] = (loss.detach(), _grads(model))
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][1].keys() == out[False][1].keys()
    for n, g in out[False][1].items():
        assert torch.equal(out[True][1][n], g), n


def test_jepa_remat_gives_the_same_gradients_with_drop_path():
    """The recompute sees the same key bias and the same drop-path draw:
    the keep masks are drawn once, before each block, and passed in."""
    cfg_kw = dict(JEPA_MODEL, drop_path_rate=0.3)
    collate = mask_collate(ModelConfig(**cfg_kw),
                           MaskConfig(pred_mask_scale=(0.2, 0.25), min_keep=2), seed=0)
    batch = {"video": torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (4, 2, 32, 32, 3), dtype=np.uint8)),
        **{k: torch.from_numpy(v) for k, v in collate(4, step=0).items()}}
    out = {}
    for remat in (False, True):
        cfg = ModelConfig(**cfg_kw, remat=remat)
        model = JEPA(cfg, seed=0)
        state = TrainState.create(model, OptimConfig(lr=0.0), seed=5, device="cpu",
                                  target=copy.deepcopy(model.encoder))
        metrics = make_jepa_train_step(cfg, total_steps=10)(state, batch)
        out[remat] = (metrics["loss"], _grads(state.model), state.generator.get_state())
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][2], out[False][2])  # the same draws, taken once
    for n, g in out[False][1].items():
        assert torch.equal(out[True][1][n], g), n


def test_drop_path_at_rate_zero_is_the_identity():
    x = torch.randn(3, 5, 16)
    blocks = Blocks(3, 16, 2, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(4)
    state = gen.get_state()
    assert torch.equal(blocks(x, "xla", drop_path_rate=0.0, generator=gen), blocks(x, "xla"))
    assert torch.equal(gen.get_state(), state)  # no draw at rate 0
    assert torch.equal(drop_path(x, None), x)
    assert torch.equal(drop_path(x, torch.ones(3, dtype=torch.bool), 1.0), x)
    # layer 0 of a schedule linspace(0, rate, depth) runs at rate 0
    with torch.no_grad():
        y = blocks(x, "xla", drop_path_rate=0.5, generator=torch.Generator().manual_seed(1))
    assert y.shape == x.shape and torch.isfinite(y).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_drop_path_matches_jax_formula(dtype):
    rate, rng = 0.3, jax.random.PRNGKey(7)
    x = np.random.default_rng(0).normal(size=(6, 5, 8)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = jax_vit.drop_path(jnp.asarray(x, jdt), jnp.float32(rate), rng)
    keep = np.asarray(jax.random.bernoulli(rng, 1.0 - jnp.float32(rate), (6, 1, 1)))
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ours = drop_path(torch.from_numpy(x).to(tdt), torch.from_numpy(keep.reshape(6)),
                     float(np.float32(1.0) - np.float32(rate)))
    assert 0 < keep.sum() < 6
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref, np.float32))


def test_block_with_drop_path_matches_jax_block_apply():
    dim, heads, rate = 16, 2, 0.4
    stacked = jax.tree_util.tree_map(np.asarray,
                                     jax_vit.init_blocks(jax.random.PRNGKey(0), 1, dim, 2.0))
    blocks = Blocks(1, dim, heads, 2.0)
    blocks.load_state_dict(_blocks(stacked, 1, ""))
    x = np.random.default_rng(1).normal(size=(5, 7, dim)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    layer = jax.tree_util.tree_map(lambda a: a[0], stacked)
    ref = jax_vit.block_apply(layer, jnp.asarray(x), heads, 1e-6, "xla", None,
                              jnp.float32(rate), rng)
    keep_prob = jnp.float32(1.0) - jnp.float32(rate)
    keep = np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(rng, i), keep_prob,
                                                     (5, 1, 1))).reshape(5)
                     for i in (0, 1)])
    with torch.no_grad():
        ours = blocks.layers[0](torch.from_numpy(x), "xla", None, torch.from_numpy(keep),
                                float(keep_prob))
    assert 0 < keep.sum() < 10
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
