"""The slice as a whole: JEPA training steps of the port against the jitted
JAX ``make_jepa_train_step`` on a 1-device mesh, from the same weights
(carried by ``jepa_from_jax_params``), clips and collator indices, in f32;
the EMA coefficient past ``total_steps + 5``; and the eval step.

The encoder is 128 wide with 2 heads (head width 64), the predictor 64 wide
with 2 heads (head width 32).  Tolerances, as the VideoMAE trajectory test
(``tests/test_torch_train_step.py``): losses rtol 5e-4 and atol 1e-5,
parameters and EMA target parameters rtol 5e-4 and atol 2e-5; the gradient
metrics rtol 1e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.models import jepa as jax_jepa
from bvc_tpu.parallel import make_mesh, shard_batch
from bvc_tpu.training.optim import make_optimizer as jax_make_optimizer
from bvc_tpu.training.state import TrainState as JaxTrainState
from bvc_tpu.training.steps import make_jepa_train_step as jax_make_step
from bvc_tpu.training.steps import place_state
from bvc_tpu.training.steps import smooth_l1 as jax_smooth_l1
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu.utils.config import OptimConfig as JaxOptimConfig
from bvc_tpu_torch.masks.multiblock import mask_collate
from bvc_tpu_torch.models.convert import jepa_encoder_from_jax_params, jepa_from_jax_params
from bvc_tpu_torch.models.jepa import JEPA
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_jepa_train_step, smooth_l1
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig

TINY = dict(family="jepa", image_size=32, patch_size=8, num_frames=2, tubelet_size=1,
            hidden_size=128, depth=2, num_heads=2, mlp_ratio=2.0, pred_depth=1,
            pred_emb_dim=64, dtype="float32")
MASK = dict(enc_mask_scale=(0.85, 1.0), pred_mask_scale=(0.2, 0.25), num_pred_masks=2,
            min_keep=2)
OPTIM = dict(name="sgd", lr=0.05, momentum=0.9, nesterov=True, weight_decay=1e-4,
             exclude_bias_and_norm_from_wd=True)
N_STEPS, B, TOTAL = 3, 4, 100
METRICS = ("grad_norm", "grad_fl", "grad_ll")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh1():
    return make_mesh({"data": 1}, jax.devices()[:1])


def _setup(n_steps=N_STEPS):
    """Perturbed JAX params (the target a copy of the encoder), and one
    batch dict per step: clips and the collator's indices of that step."""
    jcfg = JaxModelConfig(**TINY)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32),
        jax_jepa.init_params(jax.random.PRNGKey(0), jcfg))
    collate = mask_collate(ModelConfig(**TINY), MaskConfig(**MASK), seed=0)
    batches = [{"video": rng.integers(0, 256, (B, 2, 32, 32, 3), dtype=np.uint8),
                **collate(B, step=i)} for i in range(n_steps)]
    return jcfg, tree, batches


def _jax_state(tree, tx):
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = JaxTrainState.create(params, tx, jax.random.PRNGKey(1),
                                 target_params=copy.deepcopy(params["encoder"]))
    return place_state(state, _mesh1())


def _port_state(tree):
    model = JEPA(ModelConfig(**TINY))
    model.load_state_dict(jepa_from_jax_params(tree, model.cfg))
    return TrainState.create(model, OptimConfig(**OPTIM), device="cpu",
                             target=copy.deepcopy(model.encoder))


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _run_both(tree, batches, total_steps=TOTAL, grad_accum=1, attn_impl="auto"):
    mesh = _mesh1()
    tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
    jstate = _jax_state(tree, tx)
    jstep = jax_make_step(mesh, JaxModelConfig(**TINY), tx, total_steps,
                          grad_accum=grad_accum)
    state = _port_state(tree)
    step = make_jepa_train_step(ModelConfig(**TINY), total_steps, grad_accum=grad_accum,
                                attn_impl=attn_impl)
    pairs = []
    for batch in batches:
        jstate, jm = jstep(jstate, shard_batch(batch, mesh))
        pairs.append((step(state, _torch_batch(batch)), jm))
    return state, jstate, pairs


def _assert_params_match(state, jstate):
    cfg = state.model.cfg
    host = jax.tree_util.tree_map(np.array, jax.device_get(jstate.params))
    ref = jepa_from_jax_params(host, cfg)
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=5e-4, atol=2e-5, err_msg=name)
    ref_t = jepa_encoder_from_jax_params(
        jax.tree_util.tree_map(np.array, jax.device_get(jstate.target_params)), cfg)
    for name, p in state.target.named_parameters():
        assert not p.requires_grad
        np.testing.assert_allclose(p.numpy(), ref_t[name].numpy(), rtol=5e-4, atol=2e-5,
                                   err_msg="target." + name)


@pytest.mark.parametrize("attn_impl,grad_accum", [("auto", 1), ("flash", 1), ("auto", 2)],
                         ids=["auto", "flash", "grad_accum2"])
def test_three_steps_match_jax(attn_impl, grad_accum):
    _, tree, batches = _setup()
    state, jstate, pairs = _run_both(tree, batches, grad_accum=grad_accum,
                                     attn_impl=attn_impl)
    for m, jm in pairs:
        assert all(isinstance(x, torch.Tensor) and x.shape == () for x in m.values())
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=5e-4, atol=1e-5)
        for name in METRICS:
            np.testing.assert_allclose(m[name].item(), float(jm[name]), rtol=1e-4,
                                       err_msg=name)
        for name in ("mask_a", "mask_b"):
            assert m[name].item() == int(jm[name]), name
        np.testing.assert_allclose(m["ema_m"].item(), float(jm["ema_m"]), rtol=1e-6)
    assert state.step == N_STEPS == int(jstate.step)
    _assert_params_match(state, jstate)


def test_flash_and_plain_routes_agree():
    # forced 'flash' (the key-bias kernels' plain versions on the CPU)
    # against the plain attention path, in the port alone
    _, tree, batches = _setup()
    losses = {}
    for impl in ("flash", "xla"):
        state = _port_state(tree)
        step = make_jepa_train_step(ModelConfig(**TINY), TOTAL, attn_impl=impl)
        losses[impl] = [step(state, _torch_batch(b))["loss"].item() for b in batches]
        losses[impl + "_params"] = [p.detach().clone() for p in state.model.parameters()]
    np.testing.assert_allclose(losses["flash"], losses["xla"], rtol=1e-5, atol=1e-6)
    for a, b in zip(losses["flash_params"], losses["xla_params"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_ema_coefficient_past_total_steps_matches_jax():
    # total_steps=1: m = 0.996 at update 0, the uncapped ramp above 1 at
    # updates 1-5, then the fallback 0.998
    _, tree, batches = _setup(n_steps=7)
    state, jstate, pairs = _run_both(tree, batches, total_steps=1)
    ms = [m["ema_m"].item() for m, _ in pairs]
    np.testing.assert_allclose(ms, [float(jm["ema_m"]) for _, jm in pairs], rtol=1e-6)
    np.testing.assert_allclose(ms, [0.996, 1.0, 1.004, 1.008, 1.012, 1.016, 0.998],
                               rtol=1e-6)
    _assert_params_match(state, jstate)


def test_eval_step_matches_jax_and_leaves_the_state():
    _, tree, batches = _setup(n_steps=1)
    mesh = _mesh1()
    tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
    jstep = jax_make_step(mesh, JaxModelConfig(**TINY), tx, TOTAL)
    ref = jstep.eval_step(_jax_state(tree, tx), shard_batch(batches[0], mesh), 0)
    state = _port_state(tree)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = make_jepa_train_step(ModelConfig(**TINY), TOTAL)
    out = step.eval_step(state, _torch_batch(batches[0]))
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), rtol=1e-5, atol=1e-6)
    assert state.step == 0
    assert all(torch.equal(before[k], v) for k, v in state.model.state_dict().items())


def test_smooth_l1_matches_jax():
    d = np.array([-2.0, -0.5, 0.0, 0.3, 1.5, 0.999, 1.0], np.float32)
    ours = smooth_l1(torch.from_numpy(d), torch.zeros(7))
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_smooth_l1(d, np.zeros(7))),
                               rtol=1e-6)
    assert ours.dtype == torch.float32
