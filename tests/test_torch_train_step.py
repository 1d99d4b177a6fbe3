"""The slice as a whole: three training steps of the port against the jitted
JAX step ``make_videomae_train_step`` on a 1-device mesh, from the same
weights (carried by ``convert``), clips and masks (replayed from the JAX
step's ``jax.random`` splits and handed to the port through ``mask=``), in
f32; and the eval step.

Tolerances, as ``tests/test_trajectory_parity.py`` holds the JAX step to the
reference trainer in f32: losses rtol 5e-4 and atol 1e-5, final parameters
rtol 5e-4 and atol 2e-5; the four gradient metrics rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.masks.tube import tube_mask as jax_tube_mask
from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.parallel import make_mesh, shard_batch
from bvc_tpu.training.optim import make_optimizer as jax_make_optimizer
from bvc_tpu.training.state import TrainState as JaxTrainState
from bvc_tpu.training.steps import make_videomae_train_step as jax_make_step
from bvc_tpu.training.steps import place_state
from bvc_tpu.utils.config import MaskConfig as JaxMaskConfig
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu.utils.config import OptimConfig as JaxOptimConfig
from bvc_tpu_torch.models.convert import videomae_pretrain_from_jax_params
from bvc_tpu_torch.models.videomae import VideoMAEPretrain
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_videomae_train_step, microbatches
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig

TINY = dict(image_size=32, patch_size=8, num_frames=4, tubelet_size=2,
            hidden_size=64, depth=2, num_heads=2, decoder_hidden_size=32,
            decoder_depth=1, decoder_num_heads=2, dtype="float32")
MASK = dict(sampler="tube", mask_ratio=0.75)
OPTIM = dict(name="sgd", lr=0.05, momentum=0.9, nesterov=True, weight_decay=1e-4)
GRID = (2, 4, 4)
N_STEPS, B = 3, 4
METRICS = ("grad_norm", "grad_efl", "grad_ell", "grad_dll")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh1():
    return make_mesh({"data": 1}, jax.devices()[:1])


def _setup():
    jcfg = JaxModelConfig(**TINY)
    tree = jax_videomae.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32), tree)
    clips = rng.integers(0, 256, (N_STEPS, B, 4, 32, 32, 3), dtype=np.uint8)
    return jcfg, tree, clips


def _jax_state(tree, tx):
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return place_state(JaxTrainState.create(params, tx, jax.random.PRNGKey(1)), _mesh1())


def _port_state(tree):
    model = VideoMAEPretrain(ModelConfig(**TINY))
    model.load_state_dict(videomae_pretrain_from_jax_params(tree, model.cfg))
    return TrainState.create(model, OptimConfig(**OPTIM), device="cpu")


@pytest.mark.parametrize("attn_impl,grad_accum", [("auto", 1), ("flash", 1), ("auto", 2)],
                         ids=["auto", "flash", "grad_accum2"])
def test_three_steps_match_jax(attn_impl, grad_accum):
    jcfg, tree, clips = _setup()
    mesh = _mesh1()
    tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
    jstate = _jax_state(tree, tx)
    jstep = jax_make_step(mesh, jcfg, JaxMaskConfig(**MASK), tx, grad_accum=grad_accum)
    # the masks the jitted step samples: step i splits (rng, mask_rng)
    key, masks = jax.random.PRNGKey(1), []
    for _ in range(N_STEPS):
        key, mask_rng = jax.random.split(key)
        masks.append(np.array(jax_tube_mask(mask_rng, B, GRID, MASK["mask_ratio"])))

    state = _port_state(tree)
    step = make_videomae_train_step(ModelConfig(**TINY), MaskConfig(**MASK),
                                    grad_accum=grad_accum, attn_impl=attn_impl)
    for i in range(N_STEPS):
        jstate, jm = jstep(jstate, shard_batch(clips[i], mesh))
        m = step(state, torch.from_numpy(clips[i]), mask=torch.from_numpy(masks[i]))
        assert all(isinstance(x, torch.Tensor) and x.shape == () for x in m.values())
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=5e-4, atol=1e-5)
        for name in METRICS:
            np.testing.assert_allclose(m[name].item(), float(jm[name]), rtol=1e-4,
                                       err_msg=name)
    assert state.step == N_STEPS == int(jstate.step)
    ref = videomae_pretrain_from_jax_params(
        jax.tree_util.tree_map(np.array, jax.device_get(jstate.params)), state.model.cfg)
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=5e-4, atol=2e-5, err_msg=name)


def test_eval_step_matches_jax():
    jcfg, tree, clips = _setup()
    mesh = _mesh1()
    tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
    jstate = _jax_state(tree, tx)
    jstep = jax_make_step(mesh, jcfg, JaxMaskConfig(**MASK), tx)
    ref = jstep.eval_step(jstate, shard_batch(clips[0], mesh), 5)
    mask = np.array(jax_tube_mask(jax.random.fold_in(jax.random.PRNGKey(1), 5), B, GRID,
                                  MASK["mask_ratio"]))
    state = _port_state(tree)
    step = make_videomae_train_step(ModelConfig(**TINY), MaskConfig(**MASK))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    out = step.eval_step(state, torch.from_numpy(clips[0]), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), rtol=1e-5, atol=1e-6)
    # the eval step leaves the state alone, and draws a mask of its own
    # from (seed, step_idx) without advancing the state's generator
    assert state.step == 0
    assert all(torch.equal(before[k], v) for k, v in state.model.state_dict().items())
    gen_state = state.generator.get_state()
    a = step.eval_step(state, torch.from_numpy(clips[0]), 5)["loss"]
    b = step.eval_step(state, torch.from_numpy(clips[0]), 5)["loss"]
    c = step.eval_step(state, torch.from_numpy(clips[0]), 6)["loss"]
    assert torch.equal(state.generator.get_state(), gen_state)
    assert a == b and a != c


def test_step_draws_masks_from_the_state_generator():
    _, tree, clips = _setup()
    step = make_videomae_train_step(ModelConfig(**TINY), MaskConfig(**MASK))
    s1, s2 = _port_state(tree), _port_state(tree)
    l1 = [step(s1, torch.from_numpy(c))["loss"] for c in clips]
    l2 = [step(s2, torch.from_numpy(c))["loss"] for c in clips]
    assert l1 == l2 and all(torch.isfinite(x) for x in l1)
    assert s1.step == N_STEPS


def test_microbatches_are_strided():
    x = torch.arange(6)
    assert [m.tolist() for m in microbatches(x, 3)] == [[0, 3], [1, 4], [2, 5]]
    with pytest.raises(ValueError, match="must divide"):
        microbatches(x, 4)
