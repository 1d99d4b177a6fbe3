"""The pipeline-parallel VideoMAE step (slice 7d) on gloo ranks against
``bvc_tpu.parallel.pipeline.make_pipe_videomae_train_step`` on a JAX mesh
of the same shape (``make_pipe_mesh``) and against one port process at the
global batch, in f32 (depth 2, decoder depth 2: one layer of each stack a
stage at ``pipe=2``).

Each case runs three steps from the same weights (carried by ``convert``),
clips and masks, then the eval step: ``num_microbatches=2``, and
``num_microbatches=2`` with ``grad_accum=2``; at ``data=1,pipe=2`` and
``data=2,pipe=2`` with the tube sampler, and once with the random one.  The
JAX step draws its masks from ``state.rng``: they are replayed from its
splits with ``bvc_tpu.masks.tube.tube_mask`` (``pipeline.py:236-243``: its
``_local_tube_masks`` is bitwise the DP sampler's) or ``random_mask``
(``:244-258``, the same key split), and handed to the port.

Tolerances: against JAX, ``tests/test_pipeline.py``'s rtol 2e-4, atol 2e-5
(losses, the gradient norm, the final weights, the eval loss); against one
port process at the global batch, rtol 1e-5 (atol 1e-6 on the weights,
which cross zero).

Also: a checkpoint written under ``pipe=2`` (whole tensors, one process's
optimizer indices) resumes under ``replicated`` in one process; the CLI at
``--mesh data=1,pipe=2`` writes one process's losses and a checkpoint that
loads strictly; each rank holds its stage's blocks; the refusals.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from bvc_tpu.masks.tube import random_mask as jax_random_mask
from bvc_tpu.masks.tube import tube_mask as jax_tube_mask
from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.parallel import shard_batch
from bvc_tpu.parallel.pipeline import make_pipe_mesh as jax_pipe_mesh
from bvc_tpu.parallel.pipeline import make_pipe_videomae_train_step as jax_step
from bvc_tpu.parallel.pipeline import pipe_state_shardings as jax_pipe_state_shardings
from bvc_tpu.training.optim import make_optimizer as jax_make_optimizer
from bvc_tpu.training.state import TrainState as JaxTrainState
from bvc_tpu.utils.config import MaskConfig as JaxMaskConfig
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu.utils.config import OptimConfig as JaxOptimConfig
from bvc_tpu_torch.models.convert import videomae_pretrain_from_jax_params
from bvc_tpu_torch.models.videomae import VideoMAEPretrain
from bvc_tpu_torch.parallel.mesh import Mesh, check_axes, make_mesh
from bvc_tpu_torch.parallel.pipeline import (make_pipe_videomae_train_step, pipe_param_specs,
                                             pipe_state_shardings)
from bvc_tpu_torch.parallel.sharding import param_shardings
from bvc_tpu_torch.training.checkpoint import (load_checkpoint, load_optimizer_state,
                                               optimizer_state_dict)
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_videomae_train_step
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig
from torch_ranks import run_ranks

TINY = dict(image_size=32, patch_size=8, num_frames=4, tubelet_size=2, hidden_size=32,
            depth=2, num_heads=4, decoder_hidden_size=16, decoder_depth=2,
            decoder_num_heads=2, dtype="float32")
OPTIM = dict(name="sgd", lr=0.1, momentum=0.9)
GRID = (2, 4, 4)
STEPS = 3
# id: (data, pipe, runs of (sampler, num_microbatches, grad_accum)), one gloo job each
CASES = {"data1-pipe2": (1, 2, (("tube", 2, 1), ("tube", 2, 2), ("random", 2, 1))),
         "data2-pipe2": (2, 2, (("tube", 2, 1), ("tube", 2, 2)))}
SAMPLERS = {"tube": jax_tube_mask, "random": jax_random_mask}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mask(sampler: str) -> dict:
    return dict(sampler=sampler, mask_ratio=0.5)


def _setup(B: int):
    tree = jax_videomae.init_params(jax.random.PRNGKey(0), JaxModelConfig(**TINY))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32), tree)
    clips = rng.integers(0, 255, (STEPS, B, 4, 32, 32, 3), dtype=np.uint8)
    return tree, clips


def jax_run(data: int, pipe: int, sampler: str, M: int, accum: int, tree, clips) -> dict:
    """The JAX pipe step on a (data, pipe) mesh: losses, gradient norms,
    the final params, the eval loss, and the masks it drew."""
    jcfg = JaxModelConfig(**TINY)
    mesh = jax_pipe_mesh(data, pipe)
    tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, tree), tx,
                                 jax.random.PRNGKey(7))
    state = jax.tree_util.tree_map(jnp.copy,
                                   jax.device_put(state, jax_pipe_state_shardings(state, mesh)))
    step = jax_step(mesh, jcfg, JaxMaskConfig(**_mask(sampler)), tx, num_microbatches=M,
                    grad_accum=accum)
    draw, B = SAMPLERS[sampler], clips.shape[1]
    key, masks, losses, norms = jax.random.PRNGKey(7), [], [], []
    for clip in clips:
        key, mask_rng = jax.random.split(key)
        masks.append(np.array(draw(mask_rng, B, GRID, 0.5)))
        state, m = step(state, shard_batch(clip, mesh))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    eval_mask = np.array(draw(jax.random.fold_in(state.rng, 0), B, GRID, 0.5))
    ev = float(step.eval_step(state, shard_batch(clips[0], mesh), 0)["loss"])
    params = jax.tree_util.tree_map(np.array, jax.device_get(state.params))
    return {"losses": losses, "norms": norms, "eval": ev, "masks": masks,
            "eval_mask": eval_mask, "params": params}


def one_process(weights, clips, masks, eval_mask, sampler: str, accum: int,
                steps: int = STEPS) -> dict:
    """The port's unsharded step at the global batch on the same masks."""
    cfg = ModelConfig(**TINY)
    model = VideoMAEPretrain(cfg)
    model.load_state_dict(weights)
    state = TrainState.create(model, OptimConfig(**OPTIM), device="cpu")
    step = make_videomae_train_step(cfg, MaskConfig(**_mask(sampler)), grad_accum=accum)
    metrics = [{k: v.item() for k, v in step(state, torch.from_numpy(c),
                                             mask=torch.from_numpy(m)).items()}
               for c, m in zip(clips[:steps], masks[:steps])]
    ev = step.eval_step(state, torch.from_numpy(clips[0]), mask=torch.from_numpy(eval_mask))
    return {"metrics": metrics, "eval": ev["loss"].item(), "state": state, "step": step,
            "state_dict": {k: v.detach() for k, v in state.model.state_dict().items()},
            "opt": optimizer_state_dict(state.optimizer)}


@functools.cache
def _case(case: str, tmp: str) -> dict:
    """The ranks' results of ``case``, JAX's of each run, and the spec
    (memoized: the checkpoint and layout tests read the parity runs)."""
    data, pipe, runs = CASES[case]
    tree, clips = _setup(4 * data)
    cfg = ModelConfig(**TINY)
    want = {run: jax_run(data, pipe, *run, tree, clips) for run in runs}
    masks, eval_mask = {}, {}
    for (sampler, *_), w in want.items():
        masks.setdefault(sampler, w["masks"])
        eval_mask.setdefault(sampler, w["eval_mask"])
    spec = {"data": data, "pipe": pipe, "model": TINY, "mask_ratio": 0.5, "optim": OPTIM,
            "weights": videomae_pretrain_from_jax_params(tree, cfg), "clips": clips,
            "masks": masks, "eval_mask": eval_mask, "runs": list(runs)}
    ranks = run_ranks("pipe_steps", spec, f"{tmp}/{case}", world=data * pipe,
                      module="torch_pipe_ranks", timeout=240)
    return {"ranks": ranks, "jax": want, "spec": spec}


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("pipeline"))


@pytest.mark.parametrize("case,sampler", [("data1-pipe2", "tube"), ("data2-pipe2", "tube"),
                                          ("data1-pipe2", "random")],
                         ids=["data1-pipe2", "data2-pipe2", "random"])
def test_pipe_steps_match_jax_and_one_process(case, sampler, case_dir):
    """``--mesh data=D,pipe=2`` over 2D gloo ranks: three steps and the
    eval step, equal on every rank, to the JAX pipe step on a mesh of the
    same shape and to one port process at the global batch."""
    res = _case(case, case_dir)
    spec, cfg = res["spec"], ModelConfig(**TINY)
    masks, eval_mask = spec["masks"][sampler], spec["eval_mask"][sampler]
    for run, want in res["jax"].items():
        if run[0] != sampler:
            continue
        # JAX draws the same masks whatever the run: the rng splits alone decide them
        np.testing.assert_array_equal(np.stack(want["masks"]), np.stack(masks))
        jax_ref = videomae_pretrain_from_jax_params(want["params"], cfg)
        ref = one_process(spec["weights"], spec["clips"], masks, eval_mask, sampler, run[2])
        ref_losses = [m["loss"] for m in ref["metrics"]]
        for r, res_r in enumerate(res["ranks"]):
            got, what = res_r[run], f"{case} {run} rank {r}"
            assert got["step"] == STEPS
            np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4, atol=2e-5,
                                       err_msg=what)
            np.testing.assert_allclose([m["grad_norm"] for m in got["metrics"]],
                                       want["norms"], rtol=2e-4, err_msg=what)
            np.testing.assert_allclose(got["eval"], want["eval"], rtol=2e-4, atol=2e-5,
                                       err_msg=what)
            np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-5, err_msg=what)
            np.testing.assert_allclose(got["eval"], ref["eval"], rtol=1e-5, err_msg=what)
            for m, w in zip(got["metrics"], ref["metrics"]):
                assert set(m) == set(w) | {"gstat_avg", "gstat_min", "gstat_max"}, what
                for k in w:
                    np.testing.assert_allclose(m[k], w[k], rtol=1e-5, atol=1e-12,
                                               err_msg=f"{what} {k}")
            assert list(got["state_dict"]) == list(ref["state_dict"]), what
            for name, p in got["state_dict"].items():
                np.testing.assert_allclose(p.numpy(), jax_ref[name].numpy(), rtol=2e-4,
                                           atol=2e-5, err_msg=f"{what} {name}")
                np.testing.assert_allclose(p.numpy(), ref["state_dict"][name].numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=f"{what} {name}")


def test_pipe_checkpoint_resumes_under_replicated(case_dir):
    """The weights and optimizer state a ``pipe=2`` checkpoint holds are
    one process's (its key order, its optimizer's indices and groups);
    loaded into a ``replicated`` state in one process, the next step is
    the one process's fourth."""
    res = _case("data1-pipe2", case_dir)
    spec = res["spec"]
    got = res["ranks"][0]["tube", 2, 1]
    masks = spec["masks"]["tube"]
    ref = one_process(spec["weights"], spec["clips"], masks, spec["eval_mask"]["tube"], "tube",
                      1)
    assert got["opt"]["param_groups"] == ref["opt"]["param_groups"]
    assert set(got["opt"]["state"]) == set(ref["opt"]["state"])
    for i, st in ref["opt"]["state"].items():
        np.testing.assert_allclose(got["opt"]["state"][i]["momentum_buffer"].numpy(),
                                   st["momentum_buffer"].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=str(i))
    cfg = ModelConfig(**TINY)
    resumed = TrainState.create(VideoMAEPretrain(cfg), OptimConfig(**OPTIM), device="cpu")
    resumed.load_model_state_dict(got["state_dict"])
    load_optimizer_state(resumed.optimizer, got["opt"])
    clip, mask = torch.from_numpy(spec["clips"][1]), torch.from_numpy(masks[1])
    after = ref["step"](resumed, clip, mask=mask)
    want = ref["step"](ref["state"], clip, mask=mask)
    np.testing.assert_allclose(after["loss"].item(), want["loss"].item(), rtol=1e-5)
    for (k, a), b in zip(resumed.model.state_dict().items(),
                         ref["state"].model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_each_stage_holds_its_blocks(case_dir):
    """At ``data=2,pipe=2`` rank ``r`` is stage ``r % 2`` of data block
    ``r // 2``; it holds the blocks of its stage (encoder and decoder layer
    ``r % 2``) under their whole-model names, and every edge parameter
    (``pipe_param_specs``)."""
    res = _case("data2-pipe2", case_dir)
    names = list(res["spec"]["weights"])
    cfg = ModelConfig(**TINY)
    for r, out in enumerate(res["ranks"]):
        got = out["tube", 2, 1]
        assert got["coords"] == {"data": r // 2, "pipe": r % 2}
        held = set(got["held"])
        assert held == set(pipe_param_specs(names, cfg, r % 2, 2))
        assert any(n.startswith(f"encoder.blocks.layers.{r % 2}.") for n in held)
        assert not any(n.startswith(f"encoder.blocks.layers.{1 - r % 2}.") for n in held)
        assert not any(n.startswith(f"decoder.layers.{1 - r % 2}.") for n in held)
        assert {"encoder.patch_embed.weight", "mask_token", "decoder_head.bias"} <= set(held)


def test_pretrain_videomae_cli_over_two_stages(frame_corpus, tmp_path, monkeypatch):
    """``pretrain_videomae --mesh data=1,pipe=2 --pipe_microbatches 2`` on
    two gloo ranks writes the CSV losses one process writes at the same
    global batch (rtol 1e-5, the CSV's 5 decimals) and a checkpoint of
    whole tensors that loads strictly in one process, its optimizer state
    into a ``replicated`` state."""
    from bvc_tpu_torch.cli import pretrain_videomae
    from bvc_tpu_torch.training.trainer_videomae import videomae_model_state
    from test_torch_cli import _argv
    from torch_tiny_runs import VIDEOMAE_MODEL, shrink_videomae

    rid, deep = "dev_1_g0_default_0_0", {"decoder_depth": 2}
    ranks = run_ranks("pretrain_videomae", {
        "argv": _argv("videomae", frame_corpus, tmp_path / "pipe", "--mesh", "data=1,pipe=2",
                      "--pipe_microbatches", "2", "--max_epoch_iters", "3"),
        "model": deep}, tmp_path / "ranks", module="torch_pipe_ranks", timeout=180)
    ckpt = tmp_path / "pipe" / f"model_{rid}.pth.tar"
    assert ranks[0]["checkpoint"] == ranks[1]["checkpoint"] == str(ckpt)
    monkeypatch.setattr(pretrain_videomae, "config_from_args",
                        pretrain_videomae.config_from_args)
    shrink_videomae(pretrain_videomae)
    parse = pretrain_videomae.config_from_args

    def deeper(args):
        cfg = parse(args)
        cfg.model.decoder_depth = 2
        return cfg

    monkeypatch.setattr(pretrain_videomae, "config_from_args", deeper)
    pretrain_videomae.main(_argv("videomae", frame_corpus, tmp_path / "one",
                                 "--max_epoch_iters", "3"), device="cpu")

    def losses(folder):
        csv = pd.read_csv(tmp_path / folder / f"csvlog_{rid}.csv")
        return csv["train loss"].to_numpy()

    got, want = losses("pipe"), losses("one")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    cfg = ModelConfig(**{**VIDEOMAE_MODEL, **deep, "patch_size": 8})
    restored = load_checkpoint(ckpt)
    state = TrainState.create(VideoMAEPretrain(cfg), OptimConfig(), device="cpu")
    state.model.load_state_dict(videomae_model_state(restored, cfg))  # strict: every tensor
    load_optimizer_state(state.optimizer, restored["opt"])
    assert len(state.optimizer.state) == len(list(state.model.parameters()))


def test_one_stage_without_remat_equals_the_plain_step(monkeypatch):
    """``data=1,pipe=1`` in one process: the pipe step (M=2) is the plain
    step; a ``remat`` config runs its stacks without activation
    checkpointing, as JAX's ``_pipeline_stack`` calls ``run_blocks``
    without remat, and gives the same numbers."""
    cfg = ModelConfig(**TINY, remat=True)
    tree, clips = _setup(4)
    weights = videomae_pretrain_from_jax_params(tree, ModelConfig(**TINY))
    mesh = make_mesh({"data": 1, "pipe": 1})
    model = VideoMAEPretrain(cfg)
    model.load_state_dict(weights)
    state = TrainState.create(model, OptimConfig(**OPTIM), device="cpu", mesh=mesh)
    assert param_shardings("replicated", mesh).params == "pipe"
    assert pipe_state_shardings(state).n_stages == 1
    step = make_pipe_videomae_train_step(cfg, MaskConfig(**_mask("tube")), num_microbatches=2,
                                         mesh=mesh)
    calls = []
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1))
    g = torch.Generator().manual_seed(0)
    from bvc_tpu_torch.masks.tube import tube_mask

    masks = [tube_mask(g, 4, GRID, 0.5) for _ in range(2)]
    got = [step(state, torch.from_numpy(c), mask=m)["loss"].item()
           for c, m in zip(clips, masks)]
    assert not calls
    monkeypatch.undo()
    ref = one_process(weights, clips, [m.numpy() for m in masks], masks[0].numpy(), "tube", 1,
                      steps=2)
    np.testing.assert_allclose(got, [m["loss"] for m in ref["metrics"]], rtol=1e-5)


def _mesh(**shape) -> Mesh:
    return Mesh(tuple(shape), shape, {a: 0 for a in shape})


@pytest.mark.parametrize("case,match", [
    ("sampler", "supports the 'tube' and 'random' samplers"),
    ("depth", "must both divide over 2 pipeline stages"),
    ("no_pipe", r"need a \('data', 'pipe'\) mesh"),
    ("microbatches", r"num_microbatches \(3\) must divide the per-data-shard batch \(4\)"),
    ("accum", r"grad_accum_steps \(3\) must divide the per-data-shard batch \(4\)"),
    ("chunk", r"num_microbatches \(4\) must divide the per-data-shard batch \(2\)"),
    ("fsdp", "defines its own stage sharding"),
    ("seq", "runs beside 'data' only"),
    ("model", "runs beside 'data' only"),
])
def test_pipe_refuses_what_jax_refuses(case, match):
    """JAX's refusals with its messages (the sampler, depths that do not
    divide over the stages, a mesh without ``pipe``, microbatches or an
    accumulation that does not divide the rows, a ``--param_sharding``
    other than ``replicated``), and a ``pipe`` axis beside ``seq`` or
    ``model``, which JAX runs only as an accident of its ``shard_map``."""
    cfg, mask = ModelConfig(**TINY), MaskConfig(**_mask("tube"))
    one = _mesh(data=1, pipe=1)
    with pytest.raises(ValueError, match=match):
        if case == "sampler":
            make_pipe_videomae_train_step(cfg, MaskConfig(sampler="block"), mesh=one)
        elif case == "depth":
            make_pipe_videomae_train_step(ModelConfig(**{**TINY, "depth": 3}), mask,
                                          mesh=_mesh(data=1, pipe=2))
        elif case == "no_pipe":
            make_pipe_videomae_train_step(cfg, mask, mesh=_mesh(data=2))
        elif case == "fsdp":
            param_shardings("fsdp", one)
        elif case in ("seq", "model"):
            check_axes({"data": 1, "pipe": 2, case: 1})
        else:
            M, accum = {"microbatches": (3, 1), "accum": (2, 3), "chunk": (4, 2)}[case]
            state = TrainState.create(VideoMAEPretrain(cfg), OptimConfig(**OPTIM),
                                      device="cpu", mesh=one)
            step = make_pipe_videomae_train_step(cfg, mask, num_microbatches=M,
                                                 grad_accum=accum, mesh=one)
            step(state, torch.zeros((4, 4, 32, 32, 3), dtype=torch.uint8))


def test_pipe_mesh_layout_and_groups_at_world_4(tmp_path):
    """``data=2,pipe=2`` over four gloo ranks: ``pipe`` fastest; the
    ``pipe`` group holds the stages of one data block, the ``data`` group
    the ranks of one stage."""
    ranks = run_ranks("mesh_layouts", {"shapes": [{"data": 2, "pipe": 2}]}, tmp_path,
                      world=4, module="torch_seq_ranks")
    for r, (layout,) in enumerate(ranks):
        assert layout == ({"data": r // 2, "pipe": r % 2},
                          {"data": [r % 2, r % 2 + 2], "pipe": [r - r % 2, r - r % 2 + 1]})
