"""The SimCLR slice as a whole: three training steps of the port
(``make_simclr_train_step`` over a ``ResNet``) against the jitted JAX step
on a 1-device mesh, from the same weights (``resnet_from_jax_params``) and
pairs, in f32; the eval step; the interleaving; the grad-stats table of all
three families against ``bvc_tpu.training.probes``.

Tolerances, as ``tests/test_torch_train_step.py`` holds the VideoMAE step:
the three losses, and the first step's gradient metrics, parameters and
BatchNorm running statistics, rtol 5e-4 and atol 1e-5.  InfoNCE's gradient
at init has norm near 190, and the first step's gradients agree per tensor
within 4e-4 (the port's lie within 2e-5 of an f64 evaluation, JAX's within
4e-4), so at the VideoMAE test's lr 0.05 one update alone would put a
weight 1.5e-4 apart: these steps take lr 1e-4.  Past the first step ReLU
and max-pool subgradient flips amplify the rounding, as
``tests/test_trajectory_parity.py`` finds for the JAX step against the
reference trainer, so the later steps' gradient metrics are held at rtol
1e-2 and the final parameters and statistics at rtol 5e-4 plus atol 1e-4
(read: 5.7e-5 past rtol).  The grad-stats table within 1e-5 relative (the
same gradients on both sides, norms summed in other orders).

What each check catches.  At lr 1e-4 three updates move a weight by about
1e-5 to 4e-5, below the final atol, so the final state alone cannot see
the updates; the per-step losses and the gradient metrics see a wrong
forward, loss or gradient.  The three-step update itself, each parameter
tensor's ``after - init``, is held against JAX's relative to its own norm
within 5e-2 (read: 2.1e-2 at worst, the later steps' gradients): a step
that does not update, a doubled update, a wrong learning rate, momentum or
Nesterov term each move it by 30 % or more.  Weight decay at this rate
moves a weight by 1e-8 of itself a step, which no check here sees:
``tests/test_torch_optim.py`` holds it against optax.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.models import jepa as jax_jepa
from bvc_tpu.models import resnet as jax_resnet
from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.parallel import make_mesh, shard_batch
from bvc_tpu.training import probes as jax_probes
from bvc_tpu.training.optim import make_optimizer as jax_make_optimizer
from bvc_tpu.training.state import TrainState as JaxTrainState
from bvc_tpu.training.steps import make_simclr_train_step as jax_make_step
from bvc_tpu.training.steps import place_state
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu.utils.config import OptimConfig as JaxOptimConfig
from bvc_tpu_torch.models.convert import (jepa_from_jax_params, resnet_from_jax_params,
                                          videomae_pretrain_from_jax_params)
from bvc_tpu_torch.models.jepa import JEPA
from bvc_tpu_torch.models.resnet import ResNet
from bvc_tpu_torch.models.videomae import VideoMAEPretrain
from bvc_tpu_torch.objectives.contrastive import info_nce_loss
from bvc_tpu_torch.training import probes
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_simclr_train_step
from bvc_tpu_torch.utils.config import ModelConfig, OptimConfig
from torch_tiny_runs import JEPA_MODEL, VIDEOMAE_MODEL

RTOL, ATOL = 5e-4, 1e-5
ARCH, HEAD, S = "resnet18", 32, 48
OPTIM = dict(name="sgd", lr=1e-4, momentum=0.9, nesterov=True, weight_decay=1e-4)
N_STEPS, B = 3, 4
METRICS = ("grad_norm", "grad_conv1", "grad_fc0", "gstat_avg", "gstat_min", "gstat_max")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh1():
    return make_mesh({"data": 1}, jax.devices()[:1])


def _setup():
    params, stats = jax.tree_util.tree_map(
        np.asarray, jax_resnet.init_params(jax.random.PRNGKey(0), ARCH, HEAD))
    pairs = np.random.default_rng(0).integers(0, 256, (N_STEPS, B, 2, S, S, 3), dtype=np.uint8)
    return params, stats, pairs


def _jax_state(params, stats, tx):
    tree = jax.tree_util.tree_map(jnp.asarray, (params, stats))
    return place_state(JaxTrainState.create(tree[0], tx, jax.random.PRNGKey(1), extra=tree[1]),
                       _mesh1())


def _port_state(params, stats):
    model = ResNet(ARCH, HEAD)
    model.load_state_dict(resnet_from_jax_params(params, stats, ARCH))
    return TrainState.create(model, OptimConfig(**OPTIM), device="cpu")


@pytest.mark.parametrize("scope", ["global", "per_replica"])
def test_three_steps_match_jax(scope):
    """``per_replica`` negatives and BatchNorm statistics on one device are
    the global ones, in both packages."""
    params, stats, pairs = _setup()
    mesh = _mesh1()
    tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
    jstate = _jax_state(params, stats, tx)
    jstep = jax_make_step(mesh, ARCH, tx, 0.1, negatives=scope, bn_stats=scope,
                          grad_probes=jax_probes.full_grad_probes("simclr"))
    state = _port_state(params, stats)
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = make_simclr_train_step(0.1, negatives=scope, bn_stats=scope,
                                  grad_probes=probes.full_grad_probes("simclr"))
    for i in range(N_STEPS):
        jstate, jm = jstep(jstate, shard_batch(pairs[i], mesh))
        m = step(state, torch.from_numpy(pairs[i]))
        assert set(m) == {"loss", *METRICS}
        assert all(isinstance(x, torch.Tensor) and x.shape == () for x in m.values())
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=RTOL, atol=ATOL)
        for name in METRICS:
            np.testing.assert_allclose(m[name].item(), float(jm[name]),
                                       rtol=RTOL if i == 0 else 1e-2, atol=ATOL, err_msg=name)
        if i == 0:
            _assert_state_matches(state, jstate, 1, ATOL)
    assert state.step == N_STEPS == int(jstate.step)
    _assert_state_matches(state, jstate, N_STEPS, 1e-4)
    _assert_updates_match(state, jstate, init)


def _assert_state_matches(state, jstate, steps, atol):
    """Parameters and running statistics against the JAX state's."""
    ref = resnet_from_jax_params(
        *jax.tree_util.tree_map(np.array, jax.device_get((jstate.params, jstate.extra))), ARCH)
    for name, x in state.model.state_dict().items():
        if name.endswith("num_batches_tracked"):  # the port counts, as torchvision
            assert x.item() == steps
            continue
        np.testing.assert_allclose(x.numpy(), ref[name].numpy(), rtol=RTOL, atol=atol,
                                   err_msg=f"{name} after {steps} steps")


def _assert_updates_match(state, jstate, init, rel=5e-2):
    """Each parameter tensor's update since ``init`` against JAX's, relative
    to the norm of JAX's update."""
    ref = resnet_from_jax_params(*jax.device_get((jstate.params, jstate.extra)), ARCH)
    for name, x in state.model.named_parameters():
        got = (x.detach() - init[name]).double()
        want = (ref[name] - init[name]).double()
        assert want.norm() > 0, name
        assert (got - want).norm() <= rel * want.norm(), (
            name, ((got - want).norm() / want.norm()).item())


def test_eval_step_matches_jax():
    params, stats, pairs = _setup()
    mesh = _mesh1()
    tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
    jstep = jax_make_step(mesh, ARCH, tx, 0.1)
    ref = jstep.eval_step(_jax_state(params, stats, tx), shard_batch(pairs[0], mesh), 2)
    state = _port_state(params, stats)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    got = make_simclr_train_step(0.1).eval_step(state, torch.from_numpy(pairs[0]), 2)
    np.testing.assert_allclose(got["loss"].item(), float(ref["loss"]), rtol=RTOL, atol=ATOL)
    assert state.model.training and state.step == 0  # untouched
    assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())


def test_pairs_interleave():
    """[B, 2, ...] -> [2B, ...] by reshape: anchor0, pos0, anchor1, ... -- the
    loss of the step is InfoNCE over the model's features in that order, and
    a concatenation of the two views would give another loss."""
    params, stats, pairs = _setup()
    state = _port_state(params, stats)
    x = (torch.from_numpy(pairs[0]).float() / 255 - 0.5) / 0.25
    with torch.no_grad():
        feats = ResNet(ARCH, HEAD)
        feats.load_state_dict(resnet_from_jax_params(params, stats, ARCH))
        inter = info_nce_loss(feats(x.reshape(2 * B, S, S, 3)))
        cat = info_nce_loss(feats(torch.cat([x[:, 0], x[:, 1]])))
    loss = make_simclr_train_step(0.1)(state, torch.from_numpy(pairs[0]))["loss"]
    np.testing.assert_allclose(loss.item(), inter.item(), rtol=1e-6)
    assert abs(cat.item() - inter.item()) > 1e-3


def test_grad_accum_and_bad_scopes_raise():
    tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
    with pytest.raises(ValueError) as jax_err:
        jax_make_step(_mesh1(), ARCH, tx, grad_accum=2)
    with pytest.raises(ValueError) as err:
        make_simclr_train_step(grad_accum=2)
    assert str(err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="negatives"):
        make_simclr_train_step(negatives="local")


def _random_grads(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.normal(0, 1, np.shape(x)).astype(np.float32), tree)


def _set_grads(model, sd):
    for name, p in model.named_parameters():
        p.grad = sd[name].reshape(p.shape).clone()


@pytest.mark.parametrize("family", ["videomae", "jepa", "simclr"])
def test_full_grad_probes_match_jax(family):
    """The same gradients (random, one per parameter, carried by the weight
    converters) through both packages' grad-stats tables; and the log line's
    suffix is JAX's ``format_gstats`` of them."""
    if family == "simclr":
        params, stats = jax_resnet.init_params(jax.random.PRNGKey(0), ARCH, HEAD)
        grads = _random_grads(params, 1)
        model = ResNet(ARCH, HEAD)
        sd = resnet_from_jax_params(grads, jax.tree_util.tree_map(np.asarray, stats), ARCH)
    elif family == "videomae":
        cfg = JaxModelConfig(**VIDEOMAE_MODEL)
        grads = _random_grads(jax_videomae.init_params(jax.random.PRNGKey(0), cfg), 2)
        model = VideoMAEPretrain(ModelConfig(**VIDEOMAE_MODEL))
        sd = videomae_pretrain_from_jax_params(grads, model.cfg)
    else:
        cfg = JaxModelConfig(**JEPA_MODEL)
        grads = _random_grads(jax_jepa.init_params(jax.random.PRNGKey(0), cfg), 3)
        model = JEPA(ModelConfig(**JEPA_MODEL))
        sd = jepa_from_jax_params(grads, model.cfg)
    _set_grads(model, sd)
    jgrads = jax.tree_util.tree_map(jnp.asarray, grads)
    want = {k: float(fn(jgrads)) for k, fn in jax_probes.full_grad_probes(family).items()}
    got = {k: fn(model).item() for k, fn in probes.full_grad_probes(family).items()}
    assert set(got) == set(want) == {"gstat_avg", "gstat_min", "gstat_max"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    if family == "jepa":  # one norm a weight, the same set as JAX's
        np.testing.assert_allclose(np.sort(probes.per_layer_weight_norms(model).numpy()),
                                   np.sort(np.asarray(jax_probes.per_layer_weight_norms(jgrads))),
                                   rtol=1e-5)
    assert probes.format_gstats(got) == jax_probes.format_gstats(got)
    assert probes.format_gstats({"loss": 1.0}) == ""


def test_simclr_grad_metrics_match_jax():
    params, stats = jax_resnet.init_params(jax.random.PRNGKey(0), ARCH, HEAD)
    grads = _random_grads(params, 4)
    model = ResNet(ARCH, HEAD)
    _set_grads(model, resnet_from_jax_params(grads, jax.tree_util.tree_map(np.asarray, stats),
                                             ARCH))
    want = jax_probes.simclr_grad_metrics(jax.tree_util.tree_map(jnp.asarray, grads))
    got = probes.simclr_grad_metrics(model)
    for k in ("grad_norm", "grad_conv1", "grad_fc0"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_bf16_emulation_within_the_card_limits():
    """``chip_smoke.py`` holds the bf16 SimCLR step to the f32 one on the
    card under limits set from this emulation on the CPU, at the card's
    shape (224 px, 16 pairs; three seeds here): loss, the lowest gradient
    cosine per tensor (a BatchNorm bias's, a sum that cancels) and the
    running statistics."""
    cs = _chip_smoke()
    for r in cs.emulate_simclr_bf16(cs.SIMCLR_SIZE, cs.SIMCLR_AGREE_PAIRS):
        assert r["loss_rel"] <= cs.SIMCLR_BF16_LOSS_RTOL, r
        assert r["min_cosine"] >= cs.SIMCLR_BF16_COSINE_MIN, r
        assert r["stats_rel"] <= cs.SIMCLR_BF16_STATS_RTOL, r


@pytest.mark.parametrize("fault", ["bn", "info_nce"])
def test_bf16_limits_fail_an_unsound_step(fault):
    """The same limits fail a bf16 step in lower precision than the port's
    (``chip_smoke.unsound_bf16``: BatchNorm's statistics, or InfoNCE's
    cosine matrix and logsumexp, in bf16), at the card's shape, two seeds;
    the card runs the same control."""
    cs = _chip_smoke()
    for r in cs.emulate_simclr_bf16(cs.SIMCLR_SIZE, cs.SIMCLR_AGREE_PAIRS, seeds=(0, 1),
                                    fault=fault):
        assert not cs.within_bf16_limits(r), r
