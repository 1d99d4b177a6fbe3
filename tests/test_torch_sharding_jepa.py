"""V-JEPA under the parameter layouts (``--param_sharding``), three steps
on gloo ranks on the CPU (``tests/test_torch_sharding_ranks.py``): ``zero1``
and ``fsdp`` at ``data=2``, ``tp`` at ``data=1,model=2`` and at
``data=2,model=2`` (world 4), with the collator's indices of the global
batch, each rank its data coordinate's rows.

Held against ``bvc_tpu``'s jitted step with the same ``param_mode`` on a
JAX mesh of the same shape (losses rtol 1e-4; weights and the EMA target
rtol 1e-4, atol 1e-6), and against the port in one process at the global
batch (losses, weights, target and every metric, the grad-stats table
included, rtol 1e-5, atol 1e-6).  The EMA target takes the online
encoder's layout: split heads under ``tp``, ``DTensor`` shards under
``fsdp``.
"""

from __future__ import annotations

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.models import jepa as jax_jepa
from bvc_tpu.parallel import make_mesh as jax_make_mesh
from bvc_tpu.parallel import shard_batch
from bvc_tpu.training.optim import make_optimizer as jax_make_optimizer
from bvc_tpu.training.state import TrainState as JaxTrainState
from bvc_tpu.training.steps import make_jepa_train_step as jax_step
from bvc_tpu.training.steps import place_state
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu.utils.config import OptimConfig as JaxOptimConfig
from bvc_tpu_torch.masks.multiblock import mask_collate
from bvc_tpu_torch.models.convert import jepa_encoder_from_jax_params, jepa_from_jax_params
from bvc_tpu_torch.models.jepa import JEPA
from bvc_tpu_torch.training.probes import full_grad_probes
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_jepa_train_step
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig
from torch_ranks import run_ranks

JAX_RTOL, JAX_ATOL = 1e-4, 1e-6
PORT_RTOL, PORT_ATOL = 1e-5, 1e-6
N_STEPS, TOTAL = 3, 100
MODEL = dict(family="jepa", image_size=32, patch_size=8, num_frames=2, tubelet_size=1,
             hidden_size=64, depth=2, num_heads=4, mlp_ratio=2.0, pred_depth=1,
             pred_emb_dim=32, dtype="float32")
MASK = dict(enc_mask_scale=(0.85, 1.0), pred_mask_scale=(0.2, 0.25), num_pred_masks=2,
            min_keep=2)
OPTIM = dict(name="sgd", lr=0.05, momentum=0.9, nesterov=True, weight_decay=1e-4,
             exclude_bias_and_norm_from_wd=True)
CASES = {"zero1-data2": ("zero1", {"data": 2}, 4, 1),
         "fsdp-data2": ("fsdp", {"data": 2}, 4, 2),
         "tp-model2": ("tp", {"data": 1, "model": 2}, 2, 1),
         "tp-data2-model2": ("tp", {"data": 2, "model": 2}, 4, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got: dict, want: dict, rtol, atol, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


@functools.cache
def _case(case: str, tmp: str) -> dict:
    mode, mesh_shape, B, grad_accum = CASES[case]
    world = int(np.prod(list(mesh_shape.values())))
    jcfg = JaxModelConfig(**MODEL)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32),
        jax_jepa.init_params(jax.random.PRNGKey(0), jcfg))
    collate = mask_collate(ModelConfig(**MODEL), MaskConfig(**MASK), seed=0)
    batches = [{"video": rng.integers(0, 256, (B, 2, 32, 32, 3), dtype=np.uint8),
                **collate(B, step=i)} for i in range(N_STEPS)]

    mesh = jax_make_mesh(mesh_shape, jax.devices()[:world])
    tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = place_state(JaxTrainState.create(params, tx, jax.random.PRNGKey(1),
                                              target_params=copy.deepcopy(params["encoder"])),
                         mesh, mode)
    jstep = jax_step(mesh, jcfg, tx, TOTAL, param_mode=mode, grad_accum=grad_accum)
    jlosses = []
    for batch in batches:
        jstate, jm = jstep(jstate, shard_batch(batch, mesh))
        jlosses.append(float(jm["loss"]))
    host = jax.tree_util.tree_map(np.array, jax.device_get((jstate.params,
                                                             jstate.target_params)))

    weights = jepa_from_jax_params(tree, ModelConfig(**MODEL))
    model = JEPA(ModelConfig(**MODEL))
    model.load_state_dict(weights)
    one = TrainState.create(model, OptimConfig(**OPTIM), device="cpu",
                            target=copy.deepcopy(model.encoder))
    step = make_jepa_train_step(ModelConfig(**MODEL), TOTAL, grad_accum=grad_accum,
                                grad_probes=full_grad_probes("jepa"))
    metrics = [{k: v.item() for k, v in
                step(one, {k: torch.from_numpy(v) for k, v in b.items()}).items()}
               for b in batches]
    ranks = run_ranks("steps", {"family": "jepa", "mode": mode, "mesh": mesh_shape,
                                "model": MODEL, "optim": OPTIM, "weights": weights,
                                "grad_accum": grad_accum, "total_steps": TOTAL,
                                "batches": batches}, f"{tmp}/{case}", world=world,
                      module="test_torch_sharding_ranks")
    return {"ranks": ranks, "jax": (jlosses, host), "one": (metrics, one)}


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharding_jepa"))


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_and_one_process(case, case_dir):
    res = _case(case, case_dir)
    ranks, (jlosses, (jparams, jtarget)) = res["ranks"], res["jax"]
    metrics, one = res["one"]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        for k, v in r["target"].items():
            assert torch.equal(v, ranks[0]["target"][k]), k
    got = ranks[0]
    cfg = ModelConfig(**MODEL)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=JAX_RTOL)
    _close(got["state_dict"], jepa_from_jax_params(jparams, cfg), JAX_RTOL, JAX_ATOL,
           f"JAX {case}")
    _close(got["target"], jepa_encoder_from_jax_params(jtarget, cfg), JAX_RTOL, JAX_ATOL,
           f"JAX's target {case}")
    _close(got["state_dict"], one.model.state_dict(), PORT_RTOL, PORT_ATOL, "one process")
    _close(got["target"], one.target.state_dict(), PORT_RTOL, PORT_ATOL, "one's target")
    for m, want in zip(got["metrics"], metrics):
        assert set(m) == set(want) and {"gstat_avg", "grad_fl", "ema_m"} <= set(m)
        for k, w in want.items():
            np.testing.assert_allclose(m[k], w, rtol=PORT_RTOL, atol=PORT_ATOL, err_msg=k)


@pytest.mark.parametrize("case", ["fsdp-data2", "tp-model2"])
def test_target_takes_the_online_layout(case, case_dir):
    """The predictor and both encoders split alike: under ``fsdp`` every
    parameter a ``DTensor``, under ``tp`` the blocks' heads (the
    predictor's 4 heads too) and nothing else."""
    lay = _case(case, case_dir)["ranks"][0]["layout"]
    kinds = {n: k for n, (k, _) in lay["params"].items()}
    if case.startswith("fsdp"):
        assert set(kinds.values()) == {"dtensor"} and all(lay["blocks_fsdp"])
    else:
        split = {n for n, k in kinds.items() if k == "tp"}
        assert "predictor.blocks.layers.0.qkv.weight" in split
        assert len(split) == 3 * 6  # 2 encoder + 1 predictor blocks, 6 tensors each
        assert all(".blocks.layers." in n for n in split)
