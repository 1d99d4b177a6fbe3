"""VideoMAE under the parameter layouts (``--param_sharding``), three steps
on gloo ranks on the CPU (``tests/test_torch_sharding_ranks.py``), the
tiny configuration of ``tests/test_sharding_modes.py`` (32 px, patch 8, 4
frames, tubelet 2, width 32, depth 2, 4 heads, decoder 16/1/2, f32, SGD lr
0.05, momentum 0.9):

- ``zero1`` and ``fsdp`` at ``data=2``, ``tp`` at ``data=1,model=2`` and at
  ``data=2,model=2`` (world 4), against ``bvc_tpu``'s jitted step with the
  same ``param_mode`` on a JAX mesh of the same shape: losses and final
  weights within rtol 1e-4 (JAX's own tolerance between its modes), atol
  1e-6 for the weights near zero; and against the port in one process at
  the global batch: losses, weights and every metric (the gradient norms
  and the grad-stats table, read from the sharded gradients) within rtol
  1e-5, atol 1e-6 (the same sums in another order);
- the layouts: under ``tp`` a rank's ``qkv`` rows are exactly its heads of
  q, k and v (and so are the bias's), and a stack whose heads do not divide
  by the model axis stays whole; ``zero1`` keeps every parameter whole and
  partitions the momentum over the ranks; ``fsdp`` shards every parameter
  and wraps every block;
- the optimizer state a checkpoint holds (whole tensors) equals one
  process's under every mode.

The masks are JAX's tube masks for the global batch, replayed from its
step's ``jax.random`` splits and handed to both packages, as
``tests/test_torch_ddp.py`` carries them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.masks.tube import tube_mask as jax_tube_mask
from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.parallel import make_mesh as jax_make_mesh
from bvc_tpu.parallel import shard_batch
from bvc_tpu.training.optim import make_optimizer as jax_make_optimizer
from bvc_tpu.training.state import TrainState as JaxTrainState
from bvc_tpu.training.steps import make_videomae_train_step as jax_step
from bvc_tpu.training.steps import place_state
from bvc_tpu.utils.config import MaskConfig as JaxMaskConfig
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu.utils.config import OptimConfig as JaxOptimConfig
from bvc_tpu_torch.models.convert import videomae_pretrain_from_jax_params
from bvc_tpu_torch.models.videomae import VideoMAEPretrain
from bvc_tpu_torch.parallel.mesh import Mesh
from bvc_tpu_torch.parallel.sharding import shard_heads
from bvc_tpu_torch.training.checkpoint import optimizer_state_dict
from bvc_tpu_torch.training.probes import full_grad_probes
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_videomae_train_step
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig
from torch_ranks import run_ranks

JAX_RTOL, JAX_ATOL = 1e-4, 1e-6
PORT_RTOL, PORT_ATOL = 1e-5, 1e-6
N_STEPS = 3
MODEL = dict(image_size=32, patch_size=8, num_frames=4, tubelet_size=2, hidden_size=32,
             depth=2, num_heads=4, decoder_hidden_size=16, decoder_depth=1,
             decoder_num_heads=2, dtype="float32")
MASK = dict(sampler="tube", mask_ratio=0.75)
OPTIM = dict(name="sgd", lr=0.05, momentum=0.9)
# id: (mode, mesh, global batch, grad_accum)
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


def _inputs(B: int):
    """Perturbed initial JAX params (the zero biases moved), uint8 clips and
    the tube masks JAX's step draws for the global batch ``B``."""
    tree = jax_videomae.init_params(jax.random.PRNGKey(0), JaxModelConfig(**MODEL))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32), tree)
    clips = rng.integers(0, 256, (N_STEPS, B, 4, 32, 32, 3), dtype=np.uint8)
    key, masks = jax.random.PRNGKey(1), []
    for _ in range(N_STEPS):
        key, mask_rng = jax.random.split(key)
        masks.append(np.array(jax_tube_mask(mask_rng, B, (2, 4, 4), 0.75)))
    return tree, clips, masks


def _jax_run(tree, clips, mode, mesh_shape, grad_accum):
    mesh = jax_make_mesh(mesh_shape, jax.devices()[:int(np.prod(list(mesh_shape.values())))])
    tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
    state = place_state(JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, tree), tx,
                                             jax.random.PRNGKey(1)), mesh, mode)
    step = jax_step(mesh, JaxModelConfig(**MODEL), JaxMaskConfig(**MASK), tx, mode,
                    grad_accum=grad_accum)
    losses = []
    for video in clips:
        state, metrics = step(state, shard_batch(video, mesh))
        losses.append(float(metrics["loss"]))
    params = jax.tree_util.tree_map(np.array, jax.device_get(state.params))
    return losses, videomae_pretrain_from_jax_params(params, ModelConfig(**MODEL))


def _one_process(weights, clips, masks, grad_accum):
    model = VideoMAEPretrain(ModelConfig(**MODEL))
    model.load_state_dict(weights)
    state = TrainState.create(model, OptimConfig(**OPTIM), device="cpu")
    step = make_videomae_train_step(ModelConfig(**MODEL), MaskConfig(**MASK),
                                    grad_accum=grad_accum,
                                    grad_probes=full_grad_probes("videomae"))
    metrics = [{k: v.item() for k, v in step(state, torch.from_numpy(c),
                                             torch.from_numpy(m)).items()}
               for c, m in zip(clips, masks)]
    return metrics, state.model.state_dict(), optimizer_state_dict(state.optimizer)


@functools.cache
def _case(case: str, tmp: str) -> dict:
    """The ranks' results of ``case``, JAX's losses and weights, and one
    process's metrics, weights and optimizer state (memoized: the layout
    tests read the parity runs)."""
    mode, mesh_shape, B, grad_accum = CASES[case]
    world = int(np.prod(list(mesh_shape.values())))
    tree, clips, masks = _inputs(B)
    weights = videomae_pretrain_from_jax_params(tree, ModelConfig(**MODEL))
    ranks = run_ranks("steps", {
        "family": "videomae", "mode": mode, "mesh": mesh_shape, "model": MODEL, "mask": MASK,
        "optim": OPTIM, "weights": weights, "grad_accum": grad_accum,
        "batches": [{"video": c, "mask": m} for c, m in zip(clips, masks)]},
        f"{tmp}/{case}", world=world, module="test_torch_sharding_ranks")
    jlosses, jweights = _jax_run(tree, clips, mode, mesh_shape, grad_accum)
    one = _one_process(weights, clips, masks, grad_accum)
    return {"ranks": ranks, "jax": (jlosses, jweights), "one": one, "weights": weights,
            "mesh": mesh_shape}


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharding_videomae"))


def _close(got: dict, want: dict, rtol, atol, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.detach().numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_and_one_process(case, case_dir):
    res = _case(case, case_dir)
    ranks, (jlosses, jweights) = res["ranks"], res["jax"]
    metrics, one_sd, _ = res["one"]
    for r in ranks:  # every rank ends with the same losses and whole weights
        assert r["losses"] == ranks[0]["losses"] and r["step"] == N_STEPS
        for k, v in r["state_dict"].items():
            assert torch.equal(v, ranks[0]["state_dict"][k]), k
    got = ranks[0]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=JAX_RTOL)
    _close(got["state_dict"], jweights, JAX_RTOL, JAX_ATOL, f"JAX {case}")
    _close(got["state_dict"], one_sd, PORT_RTOL, PORT_ATOL, f"one process {case}")
    for m, want in zip(got["metrics"], metrics):
        assert set(m) == set(want) and {"gstat_avg", "grad_efl"} <= set(m)
        for k, w in want.items():
            np.testing.assert_allclose(m[k], w, rtol=PORT_RTOL, atol=PORT_ATOL, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_checkpoint_optimizer_state_is_one_processes(case, case_dir):
    """The optimizer state as a checkpoint holds it: rank 0's whole
    momentum tensors, in one process's index order and groups."""
    res = _case(case, case_dir)
    want = res["one"][2]
    got = res["ranks"][0]["opt"]
    assert got["param_groups"] == want["param_groups"]
    assert set(got["state"]) == set(want["state"])
    for i, st in want["state"].items():
        np.testing.assert_allclose(got["state"][i]["momentum_buffer"].numpy(),
                                   st["momentum_buffer"].numpy(), rtol=PORT_RTOL,
                                   atol=PORT_ATOL, err_msg=str(i))


def _heads_of(full: torch.Tensor, heads: range, n_heads: int) -> torch.Tensor:
    """The rows of a fused ``[3 * H * hd, ...]`` qkv tensor that are
    ``heads`` of q, then of k, then of v."""
    hd = full.shape[0] // (3 * n_heads)
    return torch.cat([full[(p * n_heads + h) * hd:(p * n_heads + h + 1) * hd]
                      for p in range(3) for h in heads])


def test_tp_rank_holds_its_heads_rows(case_dir):
    """Under ``tp`` at model=2 (and 4 ranks at data=2,model=2) each rank's
    first encoder ``qkv`` weight and bias are its two heads of q, k and v,
    the rank's model coordinate picking them; the MLP and projections hold
    their halves; LayerNorms, patch embedding, ``enc_to_dec`` and heads
    stay whole; the model goes into DDP over the data ranks."""
    for case in ("tp-model2", "tp-data2-model2"):
        res = _case(case, case_dir)
        n_model = res["mesh"]["model"]
        w = res["weights"]
        for r, out in enumerate(res["ranks"]):
            lay = out["layout"]
            m = r % n_model
            heads = range(m * 4 // n_model, (m + 1) * 4 // n_model)
            qkv_w, qkv_b = lay["qkv"]
            assert torch.equal(qkv_w, _heads_of(w["encoder.blocks.layers.0.qkv.weight"],
                                                heads, 4)), (case, r)
            assert torch.equal(qkv_b, _heads_of(w["encoder.blocks.layers.0.qkv.bias"],
                                                heads, 4)), (case, r)
            params = lay["params"]
            assert params["encoder.blocks.layers.1.qkv.weight"] == ("tp", (48, 32))
            assert params["encoder.blocks.layers.0.proj.weight"] == ("tp", (32, 16))
            assert params["encoder.blocks.layers.0.proj.bias"] == ("whole", (32,))
            assert params["encoder.blocks.layers.0.fc1.weight"] == ("tp", (64, 32))
            assert params["encoder.blocks.layers.0.fc2.weight"] == ("tp", (32, 64))
            assert params["decoder.layers.0.qkv.weight"] == ("tp", (24, 16))
            for name in ("encoder.patch_embed.weight", "enc_to_dec.weight",
                         "decoder_head.weight", "mask_token", "encoder.blocks.layers.0.ln1.weight"):
                assert params[name][0] == "whole", name
            assert lay["ddp"] and not lay["root_fsdp"]


def test_tp_indivisible_heads_stay_whole():
    """At model=4 the encoder's 4 heads split (one a rank) and the
    decoder's 2 do not: the decoder stays whole and runs unsplit; each
    rank's qkv rows are its head's."""
    weights = VideoMAEPretrain(ModelConfig(**MODEL)).state_dict()
    for r in range(4):
        model = VideoMAEPretrain(ModelConfig(**MODEL))
        shard_heads(model, Mesh(("data", "model"), {"data": 1, "model": 4},
                                {"data": 0, "model": r}, {}))
        block = model.encoder.blocks.layers[0]
        assert block.tp_size == 4 and model.decoder.layers[0].tp_size == 1
        assert torch.equal(block.qkv.weight, _heads_of(
            weights["encoder.blocks.layers.0.qkv.weight"], range(r, r + 1), 4))
        assert torch.equal(model.decoder.layers[0].qkv.weight,
                           weights["decoder.layers.0.qkv.weight"])
        assert not hasattr(model.decoder.layers[0].fc1.weight, "tp_split")


def test_zero1_keeps_params_whole_and_partitions_momentum(case_dir):
    res = _case("zero1-data2", case_dir)
    names = set(res["weights"])
    owned = [set(r["layout"]["opt_state"]) for r in res["ranks"]]
    for r in res["ranks"]:
        assert all(kind == "whole" for kind, _ in r["layout"]["params"].values())
        assert r["layout"]["ddp"]
    assert owned[0] and owned[1] and not owned[0] & owned[1]
    assert owned[0] | owned[1] == names


def test_fsdp_shards_every_parameter_and_block(case_dir):
    res = _case("fsdp-data2", case_dir)
    for r, out in enumerate(res["ranks"]):
        lay = out["layout"]
        assert lay["root_fsdp"] and all(lay["blocks_fsdp"]) and len(lay["blocks_fsdp"]) == 3
        assert not lay["ddp"]
        for name, (kind, shape) in lay["params"].items():
            full = res["weights"][name].shape
            first = -(-full[0] // 2)  # dim 0 in torch.chunk's pieces
            assert kind == "dtensor", name
            assert shape == (first if r == 0 else full[0] - first, *full[1:]), (name, shape)
