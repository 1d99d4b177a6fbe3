"""SimCLR under the parameter layouts (``--param_sharding``), three steps
of ResNet-18 on gloo ranks on the CPU (``tests/test_torch_sharding_ranks.py``)
with global negatives and BatchNorm statistics: ``zero1`` and ``fsdp`` at
``data=2``, ``tp`` at ``data=1,model=2`` and at ``data=2,model=2`` (world 4).
The ResNet matches no tensor-parallel rule, so under ``tp`` it stays whole
on every model rank and the batch is split over ``data`` only, as in the
JAX package.

Held against the port in one process at the global batch (losses, weights,
running statistics and every metric, the grad-stats table included, rtol
1e-5, atol 1e-6) and against ``bvc_tpu``'s jitted step with the same
``param_mode`` on a JAX mesh of the same shape, under
``tests/test_torch_ddp.py``'s SimCLR limits: losses rtol 5e-4, atol 1e-5;
weights rtol 5e-4, atol 1e-4 (ReLU and max-pool subgradient flips past the
first step); each tensor's update within 5e-2 of JAX's, relative.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.models import resnet as jax_resnet
from bvc_tpu.parallel import make_mesh as jax_make_mesh
from bvc_tpu.parallel import shard_batch
from bvc_tpu.training.optim import make_optimizer as jax_make_optimizer
from bvc_tpu.training.state import TrainState as JaxTrainState
from bvc_tpu.training.steps import make_simclr_train_step as jax_step
from bvc_tpu.training.steps import place_state
from bvc_tpu.utils.config import OptimConfig as JaxOptimConfig
from bvc_tpu_torch.models.convert import resnet_from_jax_params
from bvc_tpu_torch.models.resnet import ResNet
from bvc_tpu_torch.training.probes import full_grad_probes
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_simclr_train_step
from bvc_tpu_torch.utils.config import OptimConfig
from torch_ranks import run_ranks

PORT_RTOL, PORT_ATOL = 1e-5, 1e-6
JAX_RTOL, JAX_ATOL, JAX_WEIGHT_ATOL, UPDATE_REL = 5e-4, 1e-5, 1e-4, 5e-2
N_STEPS, ARCH, HEAD, S = 3, "resnet18", 32, 48
OPTIM = dict(name="sgd", lr=1e-4, momentum=0.9, nesterov=True, weight_decay=1e-4)
CASES = {"zero1-data2": ("zero1", {"data": 2}, 4),
         "fsdp-data2": ("fsdp", {"data": 2}, 4),
         "tp-model2": ("tp", {"data": 1, "model": 2}, 2),
         "tp-data2-model2": ("tp", {"data": 2, "model": 2}, 4)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _case(case: str, tmp: str) -> dict:
    mode, mesh_shape, B = CASES[case]
    world = int(np.prod(list(mesh_shape.values())))
    params, stats = jax.tree_util.tree_map(
        np.asarray, jax_resnet.init_params(jax.random.PRNGKey(0), ARCH, HEAD))
    pairs = np.random.default_rng(0).integers(0, 256, (N_STEPS, B, 2, S, S, 3), dtype=np.uint8)
    weights = resnet_from_jax_params(params, stats, ARCH)

    mesh = jax_make_mesh(mesh_shape, jax.devices()[:world])
    tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
    tree = jax.tree_util.tree_map(jnp.asarray, (params, stats))
    jstate = place_state(JaxTrainState.create(tree[0], tx, jax.random.PRNGKey(1),
                                              extra=tree[1]), mesh, mode)
    jstep = jax_step(mesh, ARCH, tx, 0.1, param_mode=mode)
    jlosses = []
    for p in pairs:
        jstate, jm = jstep(jstate, shard_batch(p, mesh))
        jlosses.append(float(jm["loss"]))
    ref = resnet_from_jax_params(
        *jax.tree_util.tree_map(np.array, jax.device_get((jstate.params, jstate.extra))), ARCH)

    model = ResNet(ARCH, HEAD)
    model.load_state_dict(weights)
    one = TrainState.create(model, OptimConfig(**OPTIM), device="cpu")
    step = make_simclr_train_step(0.1, grad_probes=full_grad_probes("simclr"))
    metrics = [{k: v.item() for k, v in step(one, torch.from_numpy(p)).items()} for p in pairs]
    ranks = run_ranks("steps", {"family": "simclr", "mode": mode, "mesh": mesh_shape,
                                "arch": ARCH, "head": HEAD, "optim": OPTIM, "weights": weights,
                                "batches": list(pairs)}, f"{tmp}/{case}", world=world,
                      module="test_torch_sharding_ranks")
    return {"ranks": ranks, "jax": (jlosses, ref), "one": (metrics, one.model.state_dict()),
            "weights": weights}


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharding_simclr"))


@pytest.mark.parametrize("case", list(CASES))
def test_matches_one_process_and_jax(case, case_dir):
    res = _case(case, case_dir)
    (metrics, one_sd), (jlosses, ref) = res["one"], res["jax"]
    got = res["ranks"][0]
    for r in res["ranks"]:
        assert r["losses"] == got["losses"]
        assert all(k in ("whole", "dtensor") for k, _ in r["layout"]["params"].values())
    assert set(got["state_dict"]) == set(one_sd)
    for k, w in one_sd.items():
        g = got["state_dict"][k]
        if k.endswith("num_batches_tracked"):
            assert g.item() == w.item(), k
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=PORT_RTOL, atol=PORT_ATOL,
                                   err_msg=k)
    for m, want in zip(got["metrics"], metrics):
        assert set(m) == set(want) and "gstat_avg" in m
        for k, w in want.items():
            np.testing.assert_allclose(m[k], w, rtol=PORT_RTOL, atol=PORT_ATOL, err_msg=k)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=JAX_RTOL, atol=JAX_ATOL)
    for k, w in res["weights"].items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got["state_dict"][k].numpy(), ref[k].numpy(),
                                   rtol=JAX_RTOL, atol=JAX_WEIGHT_ATOL, err_msg=k)
        if "running" in k:
            continue
        want = (ref[k] - w).double()
        err = ((got["state_dict"][k] - w).double() - want).norm() / want.norm()
        assert err <= UPDATE_REL, (k, err.item())
