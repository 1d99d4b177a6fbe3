"""Data-parallel training of the three families: three steps at world 2 (two
gloo processes on the CPU, ``tests/torch_ranks.py``) with b rows a rank,
held two ways:

- against the port in one process at the global batch 2b: the losses and
  every parameter (and running statistic) within rtol 1e-5, atol 1e-6 in
  f32 (DDP's mean of two rank gradients against one mean over 2b rows: the
  same sums in another order; read 1e-7 and below);
- against ``bvc_tpu``'s jitted step on a 2-device ``data`` mesh (the JAX
  package in one process; ``tests/conftest.py`` gives it 8 CPU devices):
  losses and parameters rtol 5e-4, atol 1e-5, the trainer tests' limits.
  SimCLR keeps its one-device test's final limit, atol 1e-4
  (``tests/test_torch_simclr.py``: ReLU and max-pool subgradient flips past
  the first step), and its update check.

The masks are JAX's (its tube mask replayed for the global batch) or the
port's collator's over the global batch, handed to both packages.  Every
step of every family all-reduces the gradients once, one call a DDP bucket
(a comm hook counts them), under ``grad_accum=2`` too; both ranks end with
equal parameters.  Then a world-2 trainer stage: its checkpoint against one
process's at the global batch, read by JAX through ``torch_interop``, and a
resume at world 2 bit for bit.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.masks.tube import tube_mask as jax_tube_mask
from bvc_tpu.models import jepa as jax_jepa
from bvc_tpu.models import resnet as jax_resnet
from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.models.torch_interop import load_reference_checkpoint
from bvc_tpu.parallel import make_mesh, shard_batch
from bvc_tpu.training.optim import make_optimizer as jax_make_optimizer
from bvc_tpu.training.state import TrainState as JaxTrainState
from bvc_tpu.training.steps import make_jepa_train_step as jax_jepa_step
from bvc_tpu.training.steps import make_simclr_train_step as jax_simclr_step
from bvc_tpu.training.steps import make_videomae_train_step as jax_videomae_step
from bvc_tpu.training.steps import place_state
from bvc_tpu.utils.config import MaskConfig as JaxMaskConfig
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu.utils.config import OptimConfig as JaxOptimConfig
from bvc_tpu_torch.masks.multiblock import mask_collate
from bvc_tpu_torch.models.convert import (jepa_encoder_from_jax_params, jepa_from_jax_params,
                                          resnet_from_jax_params,
                                          videomae_pretrain_from_jax_params)
from bvc_tpu_torch.models.jepa import JEPA
from bvc_tpu_torch.models.resnet import ResNet
from bvc_tpu_torch.models.videomae import VideoMAEPretrain, normalize_on_device
from bvc_tpu_torch.objectives.contrastive import info_nce_loss
from bvc_tpu_torch.training.optim import apply_schedules
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import (make_jepa_train_step, make_simclr_train_step,
                                          make_videomae_train_step)
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig
from torch_ranks import run_ranks

PORT_RTOL, PORT_ATOL = 1e-5, 1e-6
JAX_RTOL, JAX_ATOL = 5e-4, 1e-5
N_STEPS, B, WORLD = 3, 4, 2  # B: the global batch, B / WORLD rows a rank


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh2():
    return make_mesh({"data": WORLD}, jax.devices()[:WORLD])


def _perturbed(tree, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32), tree)


def _assert_ranks_agree(results):
    for k, v in results[0]["state_dict"].items():
        assert torch.equal(v, results[1]["state_dict"][k]), k
    assert results[0]["losses"] == results[1]["losses"]


def _assert_one_allreduce_a_bucket(results):
    """Each step all-reduces every bucket once: under ``grad_accum=2`` the
    first microbatch's backward runs under ``no_sync()``."""
    for r in results:
        assert len(r["buckets"]) == N_STEPS
        for seen in r["buckets"]:
            assert seen and sorted(seen) == list(range(len(seen))), r["buckets"]


def _assert_state_close(got: dict, want: dict, rtol, atol, what):
    for k, w in want.items():
        g = got[k]
        if k.endswith("num_batches_tracked"):
            assert g.item() == w.item(), k
            continue
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


# ---------------------------------------------------------------- VideoMAE

VIDEOMAE = dict(image_size=32, patch_size=8, num_frames=4, tubelet_size=2, hidden_size=64,
                depth=2, num_heads=2, decoder_hidden_size=32, decoder_depth=1,
                decoder_num_heads=2, dtype="float32")
VIDEOMAE_MASK = dict(sampler="tube", mask_ratio=0.75)
VIDEOMAE_OPTIM = dict(name="sgd", lr=0.05, momentum=0.9, nesterov=True, weight_decay=1e-4)


@pytest.mark.parametrize("grad_accum", [1, 2], ids=["grad_accum1", "grad_accum2"])
def test_videomae_world2(grad_accum, tmp_path):
    jcfg = JaxModelConfig(**VIDEOMAE)
    tree = _perturbed(jax_videomae.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    clips = rng.integers(0, 256, (N_STEPS, B, 4, 32, 32, 3), dtype=np.uint8)
    # the global batch's masks the jitted step draws: step i splits (rng, mask_rng)
    key, masks = jax.random.PRNGKey(1), []
    for _ in range(N_STEPS):
        key, mask_rng = jax.random.split(key)
        masks.append(np.array(jax_tube_mask(mask_rng, B, (2, 4, 4), 0.75)))

    mesh = _mesh2()
    tx = jax_make_optimizer(JaxOptimConfig(**VIDEOMAE_OPTIM))
    jstate = place_state(JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, tree), tx,
                                              jax.random.PRNGKey(1)), mesh)
    jstep = jax_videomae_step(mesh, jcfg, JaxMaskConfig(**VIDEOMAE_MASK), tx,
                              grad_accum=grad_accum)
    jlosses = []
    for i in range(N_STEPS):
        jstate, jm = jstep(jstate, shard_batch(clips[i], mesh))
        jlosses.append(float(jm["loss"]))

    weights = videomae_pretrain_from_jax_params(tree, ModelConfig(**VIDEOMAE))
    model = VideoMAEPretrain(ModelConfig(**VIDEOMAE))
    model.load_state_dict(weights)
    one = TrainState.create(model, OptimConfig(**VIDEOMAE_OPTIM), device="cpu")
    step = make_videomae_train_step(ModelConfig(**VIDEOMAE), MaskConfig(**VIDEOMAE_MASK),
                                    grad_accum=grad_accum)
    one_losses = [step(one, torch.from_numpy(clips[i]), torch.from_numpy(masks[i]))["loss"].item()
                  for i in range(N_STEPS)]

    results = run_ranks("videomae_steps", {
        "model": VIDEOMAE, "mask": VIDEOMAE_MASK, "optim": VIDEOMAE_OPTIM, "weights": weights,
        "grad_accum": grad_accum,
        "batches": [{"video": clips[i], "mask": masks[i]} for i in range(N_STEPS)]}, tmp_path)
    _assert_ranks_agree(results)
    _assert_one_allreduce_a_bucket(results)
    got = results[0]
    np.testing.assert_allclose(got["losses"], one_losses, rtol=PORT_RTOL, atol=PORT_ATOL)
    _assert_state_close(got["state_dict"], one.model.state_dict(), PORT_RTOL, PORT_ATOL,
                        "one process at 2b")
    np.testing.assert_allclose(got["losses"], jlosses, rtol=JAX_RTOL, atol=JAX_ATOL)
    ref = videomae_pretrain_from_jax_params(
        jax.tree_util.tree_map(np.array, jax.device_get(jstate.params)), ModelConfig(**VIDEOMAE))
    _assert_state_close(got["state_dict"], ref, JAX_RTOL, JAX_ATOL, "JAX on a data=2 mesh")
    assert got["step"] == N_STEPS == int(jstate.step)


# -------------------------------------------------------------------- JEPA

JEPA_CFG = dict(family="jepa", image_size=32, patch_size=8, num_frames=2, tubelet_size=1,
                hidden_size=128, depth=2, num_heads=2, mlp_ratio=2.0, pred_depth=1,
                pred_emb_dim=64, dtype="float32")
JEPA_MASK = dict(enc_mask_scale=(0.85, 1.0), pred_mask_scale=(0.2, 0.25), num_pred_masks=2,
                 min_keep=2)
JEPA_OPTIM = dict(name="sgd", lr=0.05, momentum=0.9, nesterov=True, weight_decay=1e-4,
                  exclude_bias_and_norm_from_wd=True)
JEPA_TOTAL = 100


def test_jepa_world2_grad_accum2(tmp_path):
    """``grad_accum=2``: each rank's two microbatches, one all-reduce a
    bucket a step; the EMA target moves by the averaged update on every
    rank.  The collator's indices are the global batch's, each rank its
    rows (``mask_a``/``mask_b`` equal on every rank)."""
    jcfg = JaxModelConfig(**JEPA_CFG)
    tree = _perturbed(jax_jepa.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    collate = mask_collate(ModelConfig(**JEPA_CFG), MaskConfig(**JEPA_MASK), seed=0)
    batches = [{"video": rng.integers(0, 256, (B, 2, 32, 32, 3), dtype=np.uint8),
                **collate(B, step=i)} for i in range(N_STEPS)]

    mesh = _mesh2()
    tx = jax_make_optimizer(JaxOptimConfig(**JEPA_OPTIM))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = place_state(JaxTrainState.create(params, tx, jax.random.PRNGKey(1),
                                              target_params=copy.deepcopy(params["encoder"])),
                         mesh)
    jstep = jax_jepa_step(mesh, jcfg, tx, JEPA_TOTAL, grad_accum=2)
    jm_all = []
    for batch in batches:
        jstate, jm = jstep(jstate, shard_batch(batch, mesh))
        jm_all.append(jm)

    weights = jepa_from_jax_params(tree, ModelConfig(**JEPA_CFG))
    model = JEPA(ModelConfig(**JEPA_CFG))
    model.load_state_dict(weights)
    one = TrainState.create(model, OptimConfig(**JEPA_OPTIM), device="cpu",
                            target=copy.deepcopy(model.encoder))
    step = make_jepa_train_step(ModelConfig(**JEPA_CFG), JEPA_TOTAL, grad_accum=2)
    one_losses = [step(one, {k: torch.from_numpy(v) for k, v in b.items()})["loss"].item()
                  for b in batches]

    results = run_ranks("jepa_steps", {"model": JEPA_CFG, "optim": JEPA_OPTIM,
                                       "weights": weights, "grad_accum": 2,
                                       "total_steps": JEPA_TOTAL, "batches": batches}, tmp_path)
    _assert_ranks_agree(results)
    _assert_one_allreduce_a_bucket(results)
    got = results[0]
    for k, v in results[0]["target"].items():
        assert torch.equal(v, results[1]["target"][k]), k
    np.testing.assert_allclose(got["losses"], one_losses, rtol=PORT_RTOL, atol=PORT_ATOL)
    _assert_state_close(got["state_dict"], one.model.state_dict(), PORT_RTOL, PORT_ATOL,
                        "one process at 2b")
    _assert_state_close(got["target"], one.target.state_dict(), PORT_RTOL, PORT_ATOL,
                        "one process's target")
    for m, jm in zip(got["metrics"], jm_all):
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=JAX_RTOL, atol=JAX_ATOL)
        assert m["mask_a"] == int(jm["mask_a"]) and m["mask_b"] == int(jm["mask_b"])
        np.testing.assert_allclose(m["ema_m"], float(jm["ema_m"]), rtol=1e-6)
    host = jax.tree_util.tree_map(np.array, jax.device_get((jstate.params,
                                                             jstate.target_params)))
    _assert_state_close(got["state_dict"], jepa_from_jax_params(host[0], ModelConfig(**JEPA_CFG)),
                        JAX_RTOL, JAX_ATOL, "JAX on a data=2 mesh")
    _assert_state_close(got["target"],
                        jepa_encoder_from_jax_params(host[1], ModelConfig(**JEPA_CFG)),
                        JAX_RTOL, JAX_ATOL, "JAX's target")


# ------------------------------------------------------------------ SimCLR

ARCH, HEAD, S = "resnet18", 32, 48
SIMCLR_OPTIM = dict(name="sgd", lr=1e-4, momentum=0.9, nesterov=True, weight_decay=1e-4)


def _one_process_simclr(weights, pairs, scope: str) -> tuple[list[float], dict]:
    """The port in one process at the global batch: the step itself for the
    global scope; for the per-replica scope the ResNet with two BatchNorm
    groups and InfoNCE with two replicas, the one-process form of two
    ranks (``bn_groups``, ``replica_ids``)."""
    model = ResNet(ARCH, HEAD)
    model.load_state_dict(weights)
    state = TrainState.create(model, OptimConfig(**SIMCLR_OPTIM), device="cpu")
    if scope == "global":
        step = make_simclr_train_step(0.1)
        return [step(state, torch.from_numpy(p))["loss"].item() for p in pairs], \
            state.model.state_dict()
    model.bn_groups = WORLD
    ids = torch.arange(WORLD).repeat_interleave(2 * B // WORLD)
    losses = []
    for p in pairs:
        x = normalize_on_device(torch.from_numpy(p))
        x = x.reshape(2 * B, *x.shape[2:])
        state.optimizer.zero_grad(set_to_none=True)
        loss = info_nce_loss(model.train()(x), 0.1, replica_ids=ids, n_replicas=WORLD)
        loss.backward()
        apply_schedules(state.optimizer, state.step)
        state.optimizer.step()
        state.step += 1
        losses.append(loss.item())
    return losses, model.state_dict()


@pytest.mark.parametrize("scope", ["global", "per_replica"])
def test_simclr_world2(scope, tmp_path):
    """``(negatives, bn_stats)`` both ``scope``: ``global`` gathers the
    features with their gradient and takes BatchNorm's statistics over both
    ranks (the port's cross-rank sums); ``per_replica`` scores each rank's
    block and takes each rank's statistics, the running ones rank 0's.
    Running statistics are held with the parameters."""
    params, stats = jax.tree_util.tree_map(
        np.asarray, jax_resnet.init_params(jax.random.PRNGKey(0), ARCH, HEAD))
    pairs = np.random.default_rng(0).integers(0, 256, (N_STEPS, B, 2, S, S, 3), dtype=np.uint8)
    weights = resnet_from_jax_params(params, stats, ARCH)

    mesh = _mesh2()
    tx = jax_make_optimizer(JaxOptimConfig(**SIMCLR_OPTIM))
    tree = jax.tree_util.tree_map(jnp.asarray, (params, stats))
    jstate = place_state(JaxTrainState.create(tree[0], tx, jax.random.PRNGKey(1), extra=tree[1]),
                         mesh)
    jstep = jax_simclr_step(mesh, ARCH, tx, 0.1, negatives=scope, bn_stats=scope)
    jlosses = []
    for p in pairs:
        jstate, jm = jstep(jstate, shard_batch(p, mesh))
        jlosses.append(float(jm["loss"]))

    one_losses, one_sd = _one_process_simclr(weights, pairs, scope)
    results = run_ranks("simclr_steps", {"arch": ARCH, "head": HEAD, "optim": SIMCLR_OPTIM,
                                         "weights": weights, "negatives": scope,
                                         "bn_stats": scope, "batches": list(pairs)}, tmp_path)
    got = results[0]
    _assert_one_allreduce_a_bucket(results)
    params0 = {k: v for k, v in got["state_dict"].items() if "running" not in k
               and "num_batches" not in k}
    for k, v in params0.items():
        assert torch.equal(v, results[1]["state_dict"][k]), k
    np.testing.assert_allclose(got["losses"], one_losses, rtol=PORT_RTOL, atol=PORT_ATOL)
    _assert_state_close(got["state_dict"], one_sd, PORT_RTOL, PORT_ATOL, "one process at 2b")
    np.testing.assert_allclose(got["losses"], jlosses, rtol=JAX_RTOL, atol=JAX_ATOL)
    ref = resnet_from_jax_params(
        *jax.tree_util.tree_map(np.array, jax.device_get((jstate.params, jstate.extra))), ARCH)
    _assert_state_close(got["state_dict"], {k: v for k, v in ref.items()
                                            if not k.endswith("num_batches_tracked")},
                        JAX_RTOL, 1e-4, "JAX on a data=2 mesh")
    # the updates themselves, relative to JAX's (tests/test_torch_simclr.py)
    for k, w in weights.items():
        if "running" in k or k.endswith("num_batches_tracked"):
            continue
        want = (ref[k] - w).double()
        err = ((got["state_dict"][k] - w).double() - want).norm() / want.norm()
        assert err <= 5e-2, (k, err.item())


# ------------------------------------------------------- trainer, checkpoint


def test_world2_checkpoint_matches_one_process_and_reads_in_jax(frame_corpus, tmp_path):
    """A VideoMAE stage at world 2 with 4 clips a rank against one process
    at 8: the checkpoint's weights within the f32 limit, ``world_size`` 2
    in its meta, one CSV written by rank 0 with the global losses; JAX's
    ``torch_interop`` reads it and embeds as the port's encoder; a stage
    stopped after its first epoch and resumed at world 2 ends bit for bit
    where the straight run does."""
    from bvc_tpu_torch.evalbench.extract import make_embed_fn
    from bvc_tpu_torch.training.checkpoint import load_checkpoint
    from bvc_tpu_torch.training.trainer_videomae import run_pretraining
    from bvc_tpu_torch.utils.config import TrainConfig
    from torch_tiny_runs import VIDEOMAE_MODEL, tiny_cfg

    results = run_ranks("videomae_stage", {"corpus": frame_corpus, "root": str(tmp_path)},
                        tmp_path / "ranks", timeout=180)
    assert results[0] == results[1]
    straight, resumed = (tmp_path / d / "model_dev_1_g0_default_0_0.pth.tar"
                         for d in ("straight", "resumed"))
    a, b = load_checkpoint(straight), load_checkpoint(resumed)
    assert a["meta"]["world_size"] == 2 and a["world_size"] == 2 and a["epoch"] == 2
    for k, v in a["model_state_dict"].items():
        assert torch.equal(v, b["model_state_dict"][k]), k
    assert a["step"] == b["step"]

    cfg = tiny_cfg(TrainConfig, "videomae", frame_corpus, tmp_path / "one",
                   "dev_1_g0_default_0_0", batch_size=8, n_epoch=2)
    run_pretraining(cfg, device="cpu")
    one = load_checkpoint(tmp_path / "one" / "model_dev_1_g0_default_0_0.pth.tar")
    for k, v in one["model_state_dict"].items():
        np.testing.assert_allclose(a["model_state_dict"][k].numpy(), v.numpy(),
                                   rtol=PORT_RTOL, atol=PORT_ATOL, err_msg=k)
    rows = (tmp_path / "straight" / "csvlog_dev_1_g0_default_0_0.csv").read_text().splitlines()
    one_rows = (tmp_path / "one" / "csvlog_dev_1_g0_default_0_0.csv").read_text().splitlines()
    assert len(rows) == len(one_rows) == 1 + 2 * 3
    np.testing.assert_allclose([float(r.split(",")[2]) for r in rows[1:]],
                               [float(r.split(",")[2]) for r in one_rows[1:]],
                               rtol=PORT_RTOL, atol=PORT_ATOL)

    m = cfg.model
    tree = load_reference_checkpoint(str(straight), depth=m.depth,
                                     decoder_depth=m.decoder_depth)
    clips = np.random.default_rng(3).integers(0, 256, (3, 4, 32, 32, 3), dtype=np.uint8)
    want = np.asarray(jax_videomae.embed(tree, jnp.asarray(clips),
                                         JaxModelConfig(**VIDEOMAE_MODEL)))
    got = make_embed_fn("videomae", str(straight), m, device="cpu")(clips)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)  # test_torch_checkpoint's limit
