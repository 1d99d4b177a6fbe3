"""The sequence-parallel VideoMAE step (slice 7c) on gloo ranks against
``bvc_tpu.parallel.seqpar.make_seq_videomae_train_step`` on a JAX mesh of
the same shape and against one port process at the global batch, in f32.

Each case runs three steps from the same weights (carried by ``convert``),
clips and tube masks (the JAX step draws them from ``state.rng``; the masks
are replayed from its splits with ``bvc_tpu.masks.tube.tube_mask``, which
``seqpar.py:142-158`` says its draw equals, and handed to the port), then
the eval step; under ``replicated``, then ``zero1`` with ``grad_accum=2``
(both against JAX's replicated step, which JAX's own tests hold its zero1
and accumulated steps to at the tolerances below).

Tolerances: against JAX, ``tests/test_seqpar.py``'s rtol 2e-4, atol 2e-5
(losses, the gradient norm, the final weights, the eval loss); against one
port process at the global batch, rtol 1e-5 (atol 1e-6 on the weights,
which cross zero).
"""

import jax
import numpy as np
import pytest
import torch

from bvc_tpu.masks.tube import tube_mask as jax_tube_mask
from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.parallel.seqpar import make_seq_mesh, make_seq_videomae_train_step as jax_step
from bvc_tpu.parallel.seqpar import shard_seq_batch
from bvc_tpu.training.optim import make_optimizer as jax_make_optimizer
from bvc_tpu.training.state import TrainState as JaxTrainState
from bvc_tpu.utils.config import MaskConfig as JaxMaskConfig
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu.utils.config import OptimConfig as JaxOptimConfig
from bvc_tpu_torch.models.convert import videomae_pretrain_from_jax_params
from bvc_tpu_torch.models.videomae import VideoMAEPretrain
from bvc_tpu_torch.parallel.mesh import Mesh
from bvc_tpu_torch.parallel.seqpar import (make_seq_tp_videomae_train_step,
                                           make_seq_videomae_train_step, time_slice,
                                           token_offset)
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_videomae_train_step
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig
from torch_ranks import run_ranks

TINY = dict(image_size=32, patch_size=8, num_frames=8, tubelet_size=2, hidden_size=32,
            depth=2, num_heads=4, decoder_hidden_size=16, decoder_depth=1,
            decoder_num_heads=2, dtype="float32")
MASK = dict(sampler="tube", mask_ratio=0.5)
OPTIM = dict(name="sgd", lr=0.1, momentum=0.9)
GRID = (4, 4, 4)
B, STEPS = 4, 3
RUNS = (("replicated", 1), ("zero1", 2))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup():
    jcfg = JaxModelConfig(**TINY)
    tree = jax_videomae.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32), tree)
    clips = rng.integers(0, 255, (STEPS, B, 8, 32, 32, 3), dtype=np.uint8)
    return jcfg, tree, clips


def jax_run(data: int, seq: int, tree, clips) -> dict:
    """The JAX seq step (``replicated``) on a (data, seq) mesh: losses,
    gradient norms, the final params, the eval loss, and the masks it
    drew."""
    jcfg = JaxModelConfig(**TINY)
    mesh = make_seq_mesh(data, seq)
    tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
    state = JaxTrainState.create(jax.tree_util.tree_map(jax.numpy.asarray, tree), tx,
                                 jax.random.PRNGKey(7))
    step = jax_step(mesh, jcfg, JaxMaskConfig(**MASK), tx)
    key, masks, losses, norms = jax.random.PRNGKey(7), [], [], []
    for clip in clips:
        key, mask_rng = jax.random.split(key)
        masks.append(np.array(jax_tube_mask(mask_rng, B, GRID, MASK["mask_ratio"])))
        state, m = step(state, shard_seq_batch(clip, mesh))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    eval_mask = np.array(jax_tube_mask(jax.random.fold_in(state.rng, 0), B, GRID,
                                       MASK["mask_ratio"]))
    ev = float(step.eval_step(state, shard_seq_batch(clips[0], mesh), 0)["loss"])
    params = jax.tree_util.tree_map(np.array, jax.device_get(state.params))
    return {"losses": losses, "norms": norms, "eval": ev, "masks": masks,
            "eval_mask": eval_mask, "params": params}


def one_process(tree, clips, masks, eval_mask, accum: int) -> dict:
    """The port's unsharded step at the global batch on the same masks."""
    cfg = ModelConfig(**TINY)
    model = VideoMAEPretrain(cfg)
    model.load_state_dict(videomae_pretrain_from_jax_params(tree, cfg))
    state = TrainState.create(model, OptimConfig(**OPTIM), device="cpu")
    step = make_videomae_train_step(cfg, MaskConfig(**MASK), grad_accum=accum)
    losses = [step(state, torch.from_numpy(c), mask=torch.from_numpy(m))["loss"].item()
              for c, m in zip(clips, masks)]
    ev = step.eval_step(state, torch.from_numpy(clips[0]), mask=torch.from_numpy(eval_mask))
    return {"losses": losses, "eval": ev["loss"].item(),
            "state_dict": {k: v.detach() for k, v in state.model.state_dict().items()}}


@pytest.mark.parametrize("data,seq", [(1, 2), (2, 2)])
def test_seq_steps_match_jax_and_one_process(data, seq, tmp_path):
    """``--mesh data=D,seq=S`` over D*S gloo ranks: ``replicated``, then
    ``zero1`` with ``grad_accum=2``, three steps and the eval step, equal
    on every rank, to the JAX seq step on a mesh of the same shape and to
    one port process at the global batch."""
    jcfg, tree, clips = _setup()
    cfg = ModelConfig(**TINY)
    weights = videomae_pretrain_from_jax_params(tree, cfg)
    # JAX's zero1 and grad_accum=2 equal its replicated step at these
    # tolerances (tests/test_seqpar.py), so one JAX run serves both
    want = jax_run(data, seq, tree, clips)
    masks, eval_mask = want["masks"], want["eval_mask"]
    jax_ref = videomae_pretrain_from_jax_params(want["params"], cfg)
    spec = {"mesh": {"data": data, "seq": seq}, "model": TINY, "mask": MASK, "optim": OPTIM,
            "weights": weights, "clips": clips, "masks": masks, "eval_mask": eval_mask,
            "runs": list(RUNS)}
    ranks = run_ranks("seq_steps", spec, tmp_path, world=data * seq,
                      module="torch_seq_ranks", timeout=240)
    for run in RUNS:
        ref = one_process(tree, clips, masks, eval_mask, run[1])
        for r, res in enumerate(ranks):
            got, what = res[run], f"{run} rank {r}"
            np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4, atol=2e-5,
                                       err_msg=what)
            np.testing.assert_allclose([m["grad_norm"] for m in got["metrics"]],
                                       want["norms"], rtol=2e-4, err_msg=what)
            np.testing.assert_allclose(got["eval"], want["eval"], rtol=2e-4, atol=2e-5,
                                       err_msg=what)
            np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5, err_msg=what)
            np.testing.assert_allclose(got["eval"], ref["eval"], rtol=1e-5, err_msg=what)
            for name, p in got["state_dict"].items():
                np.testing.assert_allclose(p.numpy(), jax_ref[name].numpy(), rtol=2e-4,
                                           atol=2e-5, err_msg=f"{what} {name}")
                np.testing.assert_allclose(p.numpy(), ref["state_dict"][name].numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=f"{what} {name}")


def test_seq_mesh_layout_and_groups_at_world_4(tmp_path):
    """``data=2,seq=2`` and ``data=1,seq=2,model=2`` over four gloo ranks:
    ``data`` outermost, ``model`` fastest; the ``seq`` ring holds the ranks
    of one (data, model) coordinate, the ``model`` group those of one
    (data, seq), the gradient group those of one ``model`` coordinate."""
    ranks = run_ranks("mesh_layouts", {"shapes": [{"data": 2, "seq": 2},
                                                  {"data": 1, "seq": 2, "model": 2}]},
                      tmp_path, world=4, module="torch_seq_ranks")
    for r, (data_seq, seq_tp) in enumerate(ranks):
        assert data_seq == ({"data": r // 2, "seq": r % 2},
                            {"data": [r % 2, r % 2 + 2], "seq": [r - r % 2, r - r % 2 + 1],
                             "gradient": "world"})
        m = r % 2
        assert seq_tp == ({"data": 0, "seq": r // 2, "model": m},
                          {"data": [r], "seq": [m, m + 2], "model": [r - m, r - m + 1],
                           "gradient": [m, m + 2]})


def _mesh(**shape) -> Mesh:
    return Mesh(tuple(shape), shape, {a: 0 for a in shape})


def test_time_slice_and_token_offset():
    """A rank's frames and first token follow its ``seq`` coordinate."""
    cfg = ModelConfig(**TINY)
    mesh = Mesh(("data", "seq"), {"data": 1, "seq": 4}, {"data": 0, "seq": 2})
    assert time_slice(cfg, mesh) == slice(4, 6) and token_offset(cfg, mesh) == 32
    assert time_slice(cfg, _mesh(data=1, seq=1)) == slice(0, 8)


@pytest.mark.parametrize("case,match", [
    ("fsdp", "'replicated' or 'zero1'"),
    ("tp", "'replicated' or 'zero1'"),
    ("random", "requires the tube sampler"),
    ("sheets", "4 temporal sheets do not split over 8 seq shards"),
    ("no_seq", r"need a \('data', 'seq'\) mesh"),
    ("tp_heads", "decoder_num_heads=2 does not divide over model=4"),
    ("tp_no_model", "needs a 'model' mesh axis"),
])
def test_seq_steps_refuse_what_jax_refuses(case, match):
    cfg, mask = ModelConfig(**TINY), MaskConfig(**MASK)
    with pytest.raises(ValueError, match=match):
        if case in ("fsdp", "tp"):
            make_seq_videomae_train_step(cfg, mask, case, mesh=_mesh(data=1, seq=2))
        elif case == "random":
            make_seq_videomae_train_step(cfg, MaskConfig(sampler="random"),
                                         mesh=_mesh(data=1, seq=2))
        elif case == "sheets":
            make_seq_videomae_train_step(cfg, mask, mesh=_mesh(data=1, seq=8))
        elif case == "no_seq":
            make_seq_videomae_train_step(cfg, mask, mesh=_mesh(data=2))
        elif case == "tp_heads":
            make_seq_tp_videomae_train_step(cfg, mask, mesh=_mesh(data=1, seq=1, model=4))
        else:
            make_seq_tp_videomae_train_step(cfg, mask, mesh=_mesh(data=1, seq=2))


def test_grad_accum_must_divide_local_rows():
    cfg = ModelConfig(**TINY)
    state = TrainState.create(VideoMAEPretrain(cfg), OptimConfig(**OPTIM), device="cpu")
    step = make_seq_videomae_train_step(cfg, MaskConfig(**MASK), grad_accum=3,
                                        mesh=_mesh(data=1, seq=1))
    with pytest.raises(ValueError, match=r"must divide the per-data-shard batch \(4\)"):
        step(state, torch.zeros((4, 8, 32, 32, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="takes its time slice"):
        step(state, torch.zeros((3, 4, 32, 32, 3), dtype=torch.uint8))
