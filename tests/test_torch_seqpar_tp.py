"""Sequence parallelism x tensor parallelism (slice 7c): the port's
``make_seq_tp_videomae_train_step`` at ``--mesh data=1,seq=2,model=2`` on
four gloo ranks against ``bvc_tpu.parallel.seqpar.
make_seq_tp_videomae_train_step`` on a JAX mesh of the same shape and
against one port process at the global batch, in f32, three steps and the
eval step (``grad_accum`` 1 and 2); and the refusals, with JAX's reasons.

The port's state holds each block's ``model`` rank's heads (7b's ``tp``
layout); its checkpoints' whole tensors are compared.  Tolerances as
``tests/test_torch_seqpar.py``: rtol 2e-4, atol 2e-5 against JAX; rtol
1e-5 (atol 1e-6 on the weights) against one process.
"""

import jax
import numpy as np
import pytest
import torch

from bvc_tpu.masks.tube import tube_mask as jax_tube_mask
from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.parallel.seqpar import make_seq_tp_mesh, shard_seq_batch
from bvc_tpu.parallel.seqpar import make_seq_tp_videomae_train_step as jax_step
from bvc_tpu.training.optim import make_optimizer as jax_make_optimizer
from bvc_tpu.training.state import TrainState as JaxTrainState
from bvc_tpu.utils.config import MaskConfig as JaxMaskConfig
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu.utils.config import OptimConfig as JaxOptimConfig
from bvc_tpu_torch.models.convert import videomae_pretrain_from_jax_params
from bvc_tpu_torch.models.videomae import VideoMAEPretrain
from bvc_tpu_torch.parallel.mesh import Mesh
from bvc_tpu_torch.parallel.seqpar import make_seq_tp_videomae_train_step
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_videomae_train_step
from bvc_tpu_torch.training.trainer_videomae import run_pretraining
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig, TrainConfig
from torch_ranks import run_ranks
from torch_tiny_runs import tiny_cfg

TINY = dict(image_size=32, patch_size=8, num_frames=8, tubelet_size=2, hidden_size=32,
            depth=2, num_heads=4, decoder_hidden_size=16, decoder_depth=1,
            decoder_num_heads=4, dtype="float32")
MASK = dict(sampler="tube", mask_ratio=0.5)
OPTIM = dict(name="sgd", lr=0.1, momentum=0.9)
GRID = (4, 4, 4)
B, STEPS = 4, 3


def test_seq_tp_steps_match_jax_and_one_process(tmp_path):
    jcfg = JaxModelConfig(**TINY)
    rng = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32),
        jax_videomae.init_params(jax.random.PRNGKey(0), jcfg))
    clips = rng.integers(0, 255, (STEPS, B, 8, 32, 32, 3), dtype=np.uint8)

    mesh = make_seq_tp_mesh(1, 2, 2)
    tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jax.numpy.asarray, tree), tx,
                                  jax.random.PRNGKey(7))
    jstep = jax_step(mesh, jcfg, JaxMaskConfig(**MASK), tx)
    key, masks, losses = jax.random.PRNGKey(7), [], []
    for clip in clips:
        key, mask_rng = jax.random.split(key)
        masks.append(np.array(jax_tube_mask(mask_rng, B, GRID, MASK["mask_ratio"])))
        jstate, m = jstep(jstate, shard_seq_batch(clip, mesh))
        losses.append(float(m["loss"]))
    eval_mask = np.array(jax_tube_mask(jax.random.fold_in(jstate.rng, 0), B, GRID,
                                       MASK["mask_ratio"]))
    jax_eval = float(jstep.eval_step(jstate, shard_seq_batch(clips[0], mesh), 0)["loss"])

    cfg = ModelConfig(**TINY)
    weights = videomae_pretrain_from_jax_params(tree, cfg)
    jax_ref = videomae_pretrain_from_jax_params(
        jax.tree_util.tree_map(np.array, jax.device_get(jstate.params)), cfg)
    runs = [("tp", 1), ("tp", 2)]
    spec = {"mesh": {"data": 1, "seq": 2, "model": 2}, "model": TINY, "mask": MASK,
            "optim": OPTIM, "weights": weights, "clips": clips, "masks": masks,
            "eval_mask": eval_mask, "runs": runs}
    ranks = run_ranks("seq_steps", spec, tmp_path, world=4, module="torch_seq_ranks",
                      timeout=240)
    for run in runs:
        model = VideoMAEPretrain(cfg)
        model.load_state_dict(weights)
        state = TrainState.create(model, OptimConfig(**OPTIM), device="cpu")
        step = make_videomae_train_step(cfg, MaskConfig(**MASK), grad_accum=run[1])
        ref = [step(state, torch.from_numpy(c), mask=torch.from_numpy(m))["loss"].item()
               for c, m in zip(clips, masks)]
        ref_eval = step.eval_step(state, torch.from_numpy(clips[0]),
                                  mask=torch.from_numpy(eval_mask))["loss"].item()
        for r, res in enumerate(ranks):
            got, what = res[run], f"{run} rank {r}"
            np.testing.assert_allclose(got["losses"], losses, rtol=2e-4, atol=2e-5, err_msg=what)
            np.testing.assert_allclose(got["eval"], jax_eval, rtol=2e-4, atol=2e-5,
                                       err_msg=what)
            np.testing.assert_allclose(got["losses"], ref, rtol=1e-5, err_msg=what)
            np.testing.assert_allclose(got["eval"], ref_eval, rtol=1e-5, err_msg=what)
            for name, p in got["state_dict"].items():
                np.testing.assert_allclose(p.numpy(), jax_ref[name].numpy(), rtol=2e-4,
                                           atol=2e-5, err_msg=f"{what} {name}")
                np.testing.assert_allclose(p.numpy(), state.model.state_dict()[name].numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=f"{what} {name}")


def _mesh(**shape) -> Mesh:
    return Mesh(tuple(shape), shape, {a: 0 for a in shape})


@pytest.mark.parametrize("mesh,match", [
    (dict(data=1, seq=1, model=8), "num_heads=4 does not divide over model=8"),
    (dict(data=1, seq=2), "needs a 'model' mesh axis"),
    (dict(data=1, model=2), r"need a \('data', 'seq'\) mesh"),
], ids=["heads", "no_model", "no_seq"])
def test_seq_tp_step_refuses_what_jax_refuses(mesh, match):
    with pytest.raises(ValueError, match=match):
        make_seq_tp_videomae_train_step(ModelConfig(**TINY), MaskConfig(**MASK),
                                        mesh=_mesh(**mesh))


@pytest.mark.parametrize("mode", ["zero1", "fsdp", "tp"])
def test_trainer_keeps_param_sharding_replicated_on_seq_tp(mode, frame_corpus, tmp_path):
    """On a mesh with ``seq`` and ``model`` the flag must stay
    ``replicated`` (the JAX trainer's refusal), before anything is written."""
    cfg = tiny_cfg(TrainConfig, "videomae", frame_corpus, tmp_path, "dev_1_g0_default_0_0")
    cfg.mesh_shape = {"data": 1, "seq": 1, "model": 1}
    cfg.param_sharding = mode
    with pytest.raises(ValueError, match="must stay 'replicated'"):
        run_pretraining(cfg, device="cpu")
    assert not any(tmp_path.iterdir())
