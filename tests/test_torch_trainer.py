"""The port's trainers (VideoMAE, JEPA, SimCLR) against ``bvc_tpu``'s:
three steps of one stage on
the same corpus, from the same initial weights, with the same global batch
(the port at ``batch_size=8`` on one device, the JAX trainer at 1 x 8 CPU
devices), and the stage logic alone (chaining, resume, accumulation,
schedules, the trainer module's names the benchmark swaps).

The JEPA masks come from the same collator code, so they match by
construction.  The VideoMAE masks are the ones the JAX step draws from its
``jax.random`` stream, handed to the port by patching its mask sampler
inside the test; the JAX initial weights are handed to the port's model by
patching its constructor inside the test.

Tolerances: the CSV losses as ``tests/test_torch_train_step.py`` holds the
steps, rtol 5e-4 and atol 1e-5; the gradient-norm columns (written with 5
significant digits) rtol 5e-4, SimCLR's past its first step rtol 1e-2 (ReLU
and max-pool subgradient flips amplify f32 rounding, as
``tests/test_torch_simclr.py`` sets out).  A resumed run's CSV and final weights
equal an uninterrupted run's bit for bit (CPU).
"""

import jax
import numpy as np
import pytest
import torch

from bvc_tpu.masks.tube import tube_mask as jax_tube_mask
from bvc_tpu.models import jepa as jax_jepa
from bvc_tpu.models import resnet as jax_resnet
from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.training.trainer_jepa import run_pretraining as jax_run_jepa
from bvc_tpu.training.trainer_simclr import run_pretraining as jax_run_simclr
from bvc_tpu.training.trainer_videomae import run_pretraining as jax_run_videomae
from bvc_tpu.utils.config import TrainConfig as JaxTrainConfig
from bvc_tpu_torch.models.convert import (jepa_from_jax_params, resnet_from_jax_params,
                                          videomae_pretrain_from_jax_params)
from bvc_tpu_torch.models.jepa import JEPA
from bvc_tpu_torch.models.resnet import ResNet
from bvc_tpu_torch.models.videomae import VideoMAEPretrain
from bvc_tpu_torch.training import steps, trainer_jepa, trainer_simclr, trainer_videomae
from bvc_tpu_torch.training.checkpoint import load_checkpoint, load_meta
from bvc_tpu_torch.training.optim import schedule_steps
from bvc_tpu_torch.utils.config import TrainConfig
from torch_tiny_runs import tiny_cfg

RTOL, ATOL = 5e-4, 1e-5
RUNS = {"videomae": (jax_run_videomae, trainer_videomae.run_pretraining),
        "jepa": (jax_run_jepa, trainer_jepa.run_pretraining),
        "simclr": (jax_run_simclr, trainer_simclr.run_pretraining)}
MODULES = {"videomae": (trainer_videomae, "make_videomae_train_step"),
           "jepa": (trainer_jepa, "make_jepa_train_step"),
           "simclr": (trainer_simclr, "make_simclr_train_step")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _csv(path):
    lines = path.read_text().splitlines()
    return lines[0], [[float(x) for x in row.split(",")] for row in lines[1:]]


def _hand_jax_init_to_port(monkeypatch, family, jcfg):
    """Patch the port trainer's model constructor to start from the JAX
    trainer's initial weights (``init_params(PRNGKey(seed))``)."""
    key = jax.random.PRNGKey(jcfg.seed)
    if family == "videomae":
        tree = jax.tree_util.tree_map(np.asarray, jax_videomae.init_params(key, jcfg.model))
        convert, cls, module = videomae_pretrain_from_jax_params, VideoMAEPretrain, trainer_videomae
        name = "VideoMAEPretrain"
    elif family == "jepa":
        tree = jax.tree_util.tree_map(np.asarray, jax_jepa.init_params(key, jcfg.model))
        convert, cls, module, name = jepa_from_jax_params, JEPA, trainer_jepa, "JEPA"
    else:
        arch = jcfg.model.architecture
        tree = jax.tree_util.tree_map(np.asarray, jax_resnet.init_params(
            key, arch, head_dim=jcfg.model.pred_emb_dim))
        cls, module, name = ResNet, trainer_simclr, "ResNet"

        def convert(tree, _arch):
            return resnet_from_jax_params(*tree, arch)

    def build(cfg, *args, **kw):
        model = cls(cfg, *args, **kw)
        model.load_state_dict(convert(tree, cfg))
        return model

    monkeypatch.setattr(module, name, build)


def _hand_jax_masks_to_port(monkeypatch, jcfg, n_steps):
    """Patch the port step's tube sampler to return the masks the JAX step
    draws: step i splits (rng, mask_rng) off the state's PRNGKey(seed + 1)."""
    m = jcfg.model
    grid = (m.num_frames // m.tubelet_size, m.image_size // m.patch_size,
            m.image_size // m.patch_size)
    key, masks = jax.random.PRNGKey(jcfg.seed + 1), []
    for _ in range(n_steps):
        key, mask_rng = jax.random.split(key)
        masks.append(torch.from_numpy(np.array(
            jax_tube_mask(mask_rng, 8, grid, jcfg.mask.mask_ratio))))
    monkeypatch.setattr(steps, "tube_mask", lambda gen, batch, grid, mask_ratio: masks.pop(0))
    return masks


@pytest.mark.parametrize("family,variant", [
    ("videomae", "plain"), ("videomae", "accum_warmup"), ("jepa", "plain"),
    ("jepa", "accum_warmup"), ("simclr", "plain"), ("simclr", "warmup")],
    ids=["plain-videomae", "accum_warmup-videomae", "plain-jepa", "accum_warmup-jepa",
         "plain-simclr", "warmup-simclr"])
def test_three_steps_match_jax(family, variant, frame_corpus, tmp_path, monkeypatch):
    """``accum_warmup``: ``grad_accum_steps=2`` and a warmup-cosine schedule
    set with ``warmup_epochs`` (one warmup step of the 3.75-step horizon);
    ``warmup``: the schedule alone (SimCLR refuses accumulation)."""
    cfgs = []
    for Cfg, batch, sub in ((JaxTrainConfig, 1, "jax"), (TrainConfig, 8, "port")):
        cfg = tiny_cfg(Cfg, family, frame_corpus, tmp_path / sub, "dev_1_g0_default_0_0",
                       batch_size=batch)
        if variant in ("accum_warmup", "warmup"):
            cfg.optim.grad_accum_steps = 2 if variant == "accum_warmup" else 1
            cfg.optim.schedule, cfg.optim.warmup_epochs = "warmup_cosine", 1 / 3
            cfg.optim.start_lr, cfg.optim.final_lr = 0.001, 0.002
        cfgs.append(cfg)
    jcfg, cfg = cfgs
    if variant != "plain":
        assert schedule_steps(cfg) == (1, 3)
    jax_run, port_run = RUNS[family]
    jax_run(jcfg)
    _hand_jax_init_to_port(monkeypatch, family, jcfg)
    if family == "videomae":
        masks = _hand_jax_masks_to_port(monkeypatch, jcfg, 3)
    port_run(cfg, device="cpu")
    if family == "videomae":
        assert masks == []  # each step took its JAX mask
    name = "csvlog_dev_1_g0_default_0_0.csv"
    header, rows = _csv(tmp_path / "port" / name)
    jheader, jrows = _csv(tmp_path / "jax" / name)
    assert header == jheader and len(rows) == len(jrows) == 3
    for row, jrow in zip(rows, jrows):
        assert row[:2] == jrow[:2]
        np.testing.assert_allclose(row[2], jrow[2], rtol=RTOL, atol=ATOL)  # the loss
        if family == "videomae":
            np.testing.assert_allclose(row[4:], jrow[4:], rtol=RTOL)
        elif family == "simclr":  # grad-conv1, grad-fc0; chaos-limited past the first step
            np.testing.assert_allclose(row[3:5], jrow[3:5], rtol=RTOL if row[1] == 0 else 1e-2)
        else:
            np.testing.assert_allclose(row[3:5], jrow[3:5], rtol=RTOL)
            assert row[5:7] == jrow[5:7]  # mask-A, mask-B


def _interrupt_after(monkeypatch, module, factory_name, n_calls):
    """Make the port's train step raise on call ``n_calls + 1``, before it
    runs: a preemption at the start of a step."""
    make = getattr(module, factory_name)

    def patched(*args, **kw):
        step = make(*args, **kw)
        calls = [0]

        def wrapped(*a, **k):
            calls[0] += 1
            if calls[0] > n_calls:
                raise KeyboardInterrupt("preempted")
            return step(*a, **k)

        wrapped.eval_step = step.eval_step
        return wrapped

    monkeypatch.setattr(module, factory_name, patched)


@pytest.mark.parametrize("family", ["videomae", "jepa", "simclr"])
def test_resume_continues_bit_for_bit(family, frame_corpus, tmp_path, monkeypatch):
    module, factory = MODULES[family]
    run = RUNS[family][1]

    def cfg_in(sub):
        cfg = tiny_cfg(TrainConfig, family, frame_corpus, tmp_path / sub, "dev_1_g0_default_0_0",
                       n_epoch=2, save_every_epoch=True)
        cfg.model.drop_path_rate = 0.1 if family == "jepa" else 0.0  # generator state matters
        return cfg

    run(cfg_in("whole"), device="cpu")
    with monkeypatch.context() as m:
        _interrupt_after(m, module, factory, 3)  # dies at the first step of epoch 2
        with pytest.raises(KeyboardInterrupt):
            run(cfg_in("split"), device="cpu")
    ckpt = tmp_path / "split" / "model_dev_1_g0_default_0_0.pth.tar"
    assert load_meta(ckpt)["epoch"] == 1
    resumed = cfg_in("split")
    resumed.resume = True
    run(resumed, device="cpu")
    name = "csvlog_dev_1_g0_default_0_0.csv"
    whole, split = ((tmp_path / sub / name).read_text().splitlines()
                    for sub in ("whole", "split"))
    if family != "videomae":  # all but the wall-clock column, 'time (ms)'
        whole, split = ([row.rsplit(",", 1)[0] for row in rows] for rows in (whole, split))
    assert split == whole and len(whole) == 1 + 6
    a = load_checkpoint(tmp_path / "whole" / ckpt.name)
    b = load_checkpoint(ckpt)
    assert a["epoch"] == b["epoch"] == 2 and a["step"] == b["step"] == 6
    assert torch.equal(a["rng"], b["rng"])
    weights = {"videomae": ("model_state_dict", "qkv_k_bias"), "simclr": ("model_state_dict",),
               "jepa": ("encoder", "predictor", "target_encoder")}[family]
    for key in weights:
        assert a[key].keys() == b[key].keys()
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    for k, s in a["opt"]["state"].items():
        assert torch.equal(s["momentum_buffer"], b["opt"]["state"][k]["momentum_buffer"])
    # a finished stage returns at once, from its meta
    with monkeypatch.context() as m:
        _interrupt_after(m, module, factory, 0)
        summary = run(resumed, device="cpu")
    assert summary["checkpoint"] == str(ckpt)


@pytest.mark.parametrize("family", ["videomae", "jepa", "simclr"])
def test_stage_chaining(family, frame_corpus, tmp_path):
    run = RUNS[family][1]
    s1 = run(tiny_cfg(TrainConfig, family, frame_corpus, tmp_path, "dev_1_g0_default_0_0"),
             device="cpu")
    stage2 = tiny_cfg(TrainConfig, family, frame_corpus, tmp_path, "dev_2_g1_default_0_0",
                      init_checkpoint_path=s1["checkpoint"])
    stage2.optim.lr *= 2  # the chained stage keeps its own hyper-parameters
    s2 = run(stage2, device="cpu")
    first = load_checkpoint(s1["checkpoint"])
    second = load_checkpoint(s2["checkpoint"])
    assert second["opt"]["param_groups"][0]["lr"] == stage2.optim.lr
    if family in ("videomae", "simclr"):
        # VideoMAE and SimCLR chain the weights (SimCLR's with the BatchNorm
        # running statistics) only: the epoch count starts again
        assert second["epoch"] == 1 and second["step"] == 3
        assert first["model_state_dict"].keys() == second["model_state_dict"].keys()
    else:
        # JEPA chains the three models and the optimizer; its epochs count on
        assert second["epoch"] == 2 and load_meta(s2["checkpoint"])["epoch"] == 2
        rows = (tmp_path / "csvlog_dev_2_g1_default_0_0.csv").read_text().splitlines()[1:]
        assert {r.split(",")[0] for r in rows} == {"2"}
    assert np.isfinite(s2["train_loss"])


def test_stage_chaining_starts_from_the_checkpoint(frame_corpus, tmp_path):
    """A chained VideoMAE stage's first loss is the loss of the first
    stage's final weights, not of a fresh init."""
    run = RUNS["videomae"][1]
    s1 = run(tiny_cfg(TrainConfig, "videomae", frame_corpus, tmp_path, "dev_1_g0_default_0_0",
                      max_epoch_iters=0), device="cpu")
    ckpt = load_checkpoint(s1["checkpoint"])
    cfg = tiny_cfg(TrainConfig, "videomae", frame_corpus, tmp_path, "x").model
    model = VideoMAEPretrain(cfg)
    model.load_state_dict(trainer_videomae.videomae_model_state(ckpt, cfg))
    fresh = VideoMAEPretrain(cfg, seed=0)
    trained = dict(model.named_parameters())
    assert any(not torch.equal(p, trained[n]) for n, p in fresh.named_parameters())
    # the checkpoint keeps the k thirds of the qkv biases HF's layout drops
    assert set(ckpt["qkv_k_bias"]) == {n for n in trained if n.endswith("qkv.bias")}
    assert ckpt["world_size"] == 1 and ckpt["batch_size"] == 8


def test_val_phase_and_async_save(frame_corpus, tmp_path):
    """``keep_val``: a val phase through ``eval_step`` after each epoch's
    training, its loss in the CSV's val column; ``async_save``: the
    checkpoint written on a background thread is complete when the stage
    returns."""
    cfg = tiny_cfg(TrainConfig, "videomae", frame_corpus, tmp_path, "dev_1_g0_default_0_7",
                   async_save=True)
    cfg.data.keep_val, cfg.data.n_trainsamples = True, 16
    summary = trainer_videomae.run_pretraining(cfg, device="cpu")
    assert summary["val_loss"] > 0 and np.isfinite(summary["train_loss"])
    rows = (tmp_path / "csvlog_dev_1_g0_default_0_7.csv").read_text().splitlines()[1:]
    val_rows = [r for r in rows if float(r.split(",")[2]) == 0.0]
    assert val_rows and all(float(r.split(",")[3]) > 0 for r in val_rows)
    assert load_meta(summary["checkpoint"])["val_loss"] == summary["val_loss"]


@pytest.mark.parametrize("family", ["videomae", "jepa", "simclr"])
def test_the_stage_takes_the_trainer_modules_loader_and_pipe(family, frame_corpus, tmp_path,
                                                             monkeypatch):
    """The benchmark's train window swaps ``DataLoader`` and ``MetricsPipe``
    on the trainer module for the length of a run (``portbench/drivers/train.py``):
    the stage serves its batches from the swapped loader and reads its
    metrics through the swapped pipe."""
    module, used = MODULES[family][0], {"epochs": 0, "pushes": 0}

    class Loader(module.DataLoader):
        def epoch(self, epoch):
            used["epochs"] += 1
            return super().epoch(epoch)

    class Pipe(module.MetricsPipe):
        def push(self, *args, **kw):
            used["pushes"] += 1
            return super().push(*args, **kw)

    monkeypatch.setattr(module, "DataLoader", Loader)
    monkeypatch.setattr(module, "MetricsPipe", Pipe)
    cfg = tiny_cfg(TrainConfig, family, frame_corpus, tmp_path, "dev_1_g0_default_0_0",
                   batch_size=4)
    module.run_pretraining(cfg, device="cpu")
    assert used == {"epochs": 1, "pushes": cfg.max_epoch_iters}
