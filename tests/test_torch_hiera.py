"""Hiera video MAE on the port's VideoMAE path (``models/hiera.py``) against
the plain reference of ``tests/reference_hiera.py`` on the CPU, at a tiny
size: 4 frames of 64 x 64, patch stride (2, 4, 4), mask units of 1 x 8 x 8
tokens (2 x 2 a frame pair, 8 a clip), four stages of depth (1, 2, 2, 1)
from width 32 with heads of 16, queries pooled twice, a decoder 32 wide.

Also the layout steps against index arithmetic and ``F.max_pool3d``, the
mask-unit sampler, the masked conv, the CLI, the curriculum and extraction
of a Hiera checkpoint, the layouts it refuses, and VideoMAE's step left bit
for bit as it was.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import reference_hiera as ref
from bvc_tpu_torch.cli import pretrain_videomae
from bvc_tpu_torch.evalbench.extract import make_embed_fn, untrained_embed_fn
from bvc_tpu_torch.masks.tube import mask_unit_mask
from bvc_tpu_torch.models.hiera import (HieraEncoder, HieraMAE, mask_unit_attention, pool,
                                        reroll, undo_windowing, unroll)
from bvc_tpu_torch.models.videomae import VideoMAEPretrain
from bvc_tpu_torch.serving.export import export_embed
from bvc_tpu_torch.training import trainer_videomae
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_videomae_train_step, mask_sampler
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig, TrainConfig

TINY = dict(architecture="hiera", image_size=64, patch_size=4, num_frames=4, tubelet_size=2,
            hidden_size=32, depth=6, stage_depths=(1, 2, 2, 1), stage_heads=(2, 4, 8, 16),
            decoder_hidden_size=32, decoder_depth=1, decoder_num_heads=2, layer_norm_eps=1e-6,
            dtype="float32")
UNITS = (2, 2, 2)
LR = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw) -> ModelConfig:
    return ModelConfig(**{**TINY, **kw})


def _fields(cfg: ModelConfig) -> dict:
    return {k: (list(v) if isinstance(v, tuple) else v) for k, v in
            dataclasses.asdict(cfg).items()}


def _seeded(model: torch.nn.Module, seed: int) -> dict:
    """Weights from one normal draw in sorted name order: norms' scales
    1 + 0.1 z, everything else 0.02 z (so biases and tables get gradients
    of their own size); loaded into ``model``, returned as a dict."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in sorted(model.state_dict().items()):
        z = torch.randn(t.shape, generator=gen)
        norm = name.endswith(".weight") and name.split(".")[-2] in ("ln1", "ln2", "norm",
                                                                     "decoder_norm")
        out[name] = 1.0 + 0.1 * z if norm else 0.02 * z
    model.load_state_dict(out)
    return out


def _video(B: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (B, 4, 64, 64, 3),
                                                                 dtype=np.uint8))


def _ref_loss(p: dict, video, masked, cfg) -> torch.Tensor:
    m = _fields(cfg)
    n_masked = int(masked[0].sum())
    return ref.pretrain_loss_sum(p, video, masked, m) / (
        masked.shape[0] * n_masked * 4 * 16 * 16 * 3)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


# -- the model against the reference ---------------------------------------------------


def test_loss_and_every_gradient_match_the_reference():
    cfg = _cfg()
    model = HieraMAE(cfg, seed=0)
    params = _seeded(model, 11)
    video = _video(2, 1)
    masked = mask_unit_mask(torch.Generator().manual_seed(2), 2, UNITS, 0.5)
    loss = model(video, masked, 4)
    loss.backward()
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want = _ref_loss(p, video, masked, cfg)
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-6 * abs(want.item())
    for name, q in model.named_parameters():
        assert _rel(q.grad, p[name].grad) <= 1e-4, name


def test_two_sgd_steps_match_the_reference():
    """The port's VideoMAE step (mask-unit masks from the state's
    generator) against the reference's loss, gradients and PyTorch's
    Nesterov SGD, over two steps."""
    cfg = _cfg()
    model = HieraMAE(cfg, seed=0)
    params = _seeded(model, 12)
    state = TrainState.create(model, OptimConfig(lr=LR), seed=7, device="cpu")
    step = make_videomae_train_step(cfg, MaskConfig(sampler="mask_unit", mask_ratio=0.5))
    gen = torch.Generator().manual_seed(7)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    buf = {}
    for i in range(2):
        video = _video(2, 20 + i)
        masked = mask_unit_mask(gen, 2, UNITS, 0.5)
        out = step(state, video)
        want = _ref_loss(p, video, masked, cfg)
        grads = torch.autograd.grad(want, list(p.values()))
        assert abs(out["loss"].item() - want.item()) <= 1e-6 * abs(want.item())
        with torch.no_grad():
            for (k, v), g in zip(p.items(), grads):
                buf[k] = g.clone() if i == 0 else buf[k].mul_(0.9).add_(g)
                v.sub_(LR * (g + 0.9 * buf[k]))
    for name, q in state.model.named_parameters():
        delta, want = q.detach() - params[name], p[name].detach() - params[name]
        assert _rel(delta, want) <= 1e-4, name


def test_mask_unit_attention_counts_its_windows_and_runs_in_its_range():
    cfg = _cfg()
    model = HieraMAE(cfg, seed=0)
    masked = mask_unit_mask(torch.Generator().manual_seed(3), 2, UNITS, 0.5)
    before = mask_unit_attention.windows
    with torch.profiler.profile() as prof:
        model(_video(2, 3), masked, 4).backward()
    # stage 1 (1 block), stage 2 (2 blocks) and stage 3's first block: 4 kept units a clip
    assert mask_unit_attention.windows - before == 4 * 2 * 4
    names = collections.Counter(e.name for e in prof.events())
    assert names["bvc::mask_unit_attn"] == 8  # 4 forward, 4 backward
    assert names["bvc::hiera.fusion"] == 1


# -- layout steps ----------------------------------------------------------------------


@pytest.mark.parametrize("size,levels", [((2, 16, 16), 3), ((4, 8, 8), 2), ((1, 4, 8), 1)])
def test_unroll_then_reroll_is_the_identity(size, levels):
    B, C = 2, 5
    sched = [(1, 2, 2)] * levels
    x = torch.randn(B, math.prod(size), C)
    unit = (1, 2 ** levels, 2 ** levels)
    units = tuple(s // u for s, u in zip(size, unit))
    back = undo_windowing(reroll(unroll(x, size, sched), math.prod(units), sched), units, unit)
    assert torch.equal(back.reshape(B, -1, C), x)


def test_undo_windowing_is_the_references_index_arithmetic():
    grid, unit = (4, 6, 8), (2, 3, 4)
    units = tuple(g // u for g, u in zip(grid, unit))
    x = torch.randn(2, math.prod(units), *unit, 3)
    got = undo_windowing(x, units, unit).reshape(2, -1, 3)
    places = ref.unit_places(grid, unit, "cpu")  # raster index of (unit, place)
    want = torch.empty_like(got)
    want[:, places.flatten()] = x.reshape(2, -1, 3)
    assert torch.equal(got, want)


def test_pool_after_unroll_is_max_pool3d():
    size, B, C = (2, 16, 16), 2, 3
    x = torch.randn(B, math.prod(size), C)
    pooled = pool(unroll(x, size, [(1, 2, 2)] * 3), 4)
    grid = x.reshape(B, *size, C).permute(0, 4, 1, 2, 3)
    want = F.max_pool3d(grid, (1, 2, 2), (1, 2, 2)).permute(0, 2, 3, 4, 1)
    assert torch.equal(pooled, unroll(want.reshape(B, -1, C), (2, 8, 8), [(1, 2, 2)] * 2))


@pytest.mark.parametrize("ratio", [0.9, 0.75, 0.5])
def test_mask_unit_sampler_keeps_hieras_count(ratio):
    n = 392
    a = mask_unit_mask(torch.Generator().manual_seed(5), 6, (8, 7, 7), ratio)
    b = mask_unit_mask(torch.Generator().manual_seed(5), 6, (8, 7, 7), ratio)
    assert a.shape == (6, n) and torch.equal(a, b)
    assert ((~a).sum(1) == int(n * (1 - ratio))).all()
    big = ModelConfig(architecture="hiera", patch_size=4)
    draw, visible = mask_sampler(big, MaskConfig(sampler="mask_unit", mask_ratio=ratio))
    assert visible == int(n * (1 - ratio))
    assert torch.equal(draw(torch.Generator().manual_seed(5), 6), a)
    if ratio == 0.9:
        assert visible == 39


def test_the_masked_conv_leaves_no_masked_pixel_in_a_kept_token():
    cfg = _cfg()
    enc = HieraEncoder(cfg, seed=0)
    video = _video(2, 4).float()
    masked = mask_unit_mask(torch.Generator().manual_seed(6), 2, UNITS, 0.5)
    keep = torch.arange(8).expand(2, -1)[~masked].reshape(2, -1)
    noisy = video.clone()
    for b in range(2):  # every pixel of a masked unit (2 frames x 32 x 32) redrawn
        for u in torch.nonzero(masked[b]).flatten().tolist():
            t, y, x = u // 4, (u // 2) % 2, u % 2
            noisy[b, 2 * t:2 * t + 2, 32 * y:32 * y + 32, 32 * x:32 * x + 32] = 1e3
    with torch.no_grad():
        assert torch.equal(enc.tokens(video, keep), enc.tokens(noisy, keep))
        unmasked = HieraEncoder(_cfg(), seed=0)
        assert not torch.equal(unmasked.tokens(video, None), unmasked.tokens(noisy, None))


def test_layout_must_fit_the_unroll():
    with pytest.raises(ValueError, match="mask_unit_size"):
        HieraEncoder(_cfg(mask_unit_size=(1, 4, 4)))


# -- VideoMAE's step, bit for bit --------------------------------------------------------

# sha256 of the metrics of two steps and the state after them, and the count
# and digest of the profiled operator names of one step, recorded from the
# tree before Hiera was added (torch on the CPU, one thread)
VMAE_DIGEST = {"bfloat16": "22e8eccb43fa99006bfcba8c3e93fbd1184ed146e0a8321a9d2e63f62c0ffe54",
               "float32": "3a48de96756a697b5863ab43b32ecd4ef166f86582b44382eca3c74dfb859742"}
VMAE_OPS = {"bfloat16": (4688, "e9465dd2fce364eb"), "float32": (3529, "156c9d2871a502a6")}


def _vmae(dtype):
    cfg = ModelConfig(image_size=32, patch_size=8, num_frames=4, tubelet_size=2, hidden_size=64,
                      depth=2, num_heads=2, decoder_hidden_size=32, decoder_depth=1,
                      decoder_num_heads=2, dtype=dtype)
    state = TrainState.create(VideoMAEPretrain(cfg, seed=3), OptimConfig(lr=0.1), seed=4,
                              device="cpu")
    step = make_videomae_train_step(cfg, MaskConfig(mask_ratio=0.75))
    rng = np.random.default_rng(0)
    videos = [torch.from_numpy(rng.integers(0, 256, (4, 4, 32, 32, 3), dtype=np.uint8))
              for _ in range(2)]
    return state, step, videos


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_videomae_step_is_bit_for_bit_as_before(dtype):
    state, step, videos = _vmae(dtype)
    h = hashlib.sha256()
    for video in videos:
        out = step(state, video)
        for k in sorted(out):
            h.update(out[k].float().numpy().tobytes())
    for t in state.model.state_dict().values():
        h.update(t.float().numpy().tobytes())
    assert h.hexdigest() == VMAE_DIGEST[dtype]
    state, step, videos = _vmae(dtype)
    with torch.profiler.profile() as prof:
        step(state, videos[0])
    names = sorted(collections.Counter(e.name for e in prof.events()).items())
    assert (sum(n for _, n in names),
            hashlib.sha256(repr(names).encode()).hexdigest()[:16]) == VMAE_OPS[dtype]


# -- the normal path: CLI, curriculum, extraction, layouts ---------------------------------


def _cli_argv(frame_corpus, savedir, *extra):
    return ["-jpg_root", frame_corpus, "-savedir", str(savedir), "--batch_size", "2",
            "--n_trainsamples", "16", "--max_epoch_iters", "2", "--segment_minutes", "0.02",
            "--num_workers", "2", "--run_id", "dev_1_g0_default_0_0", "--image_size", "64",
            "--architecture", "hiera", "--num_frames", "4", "--hidden_size", "32",
            "--stage_depths", "1", "2", "2", "1", "--stage_heads", "2", "4", "8", "16",
            "--decoder_hidden_size", "32", "--decoder_depth", "1", "--decoder_num_heads", "2",
            "--mask_ratio", "0.5", *extra]


def test_cli_flags_lay_hiera_over_its_preset(frame_corpus, tmp_path):
    args = pretrain_videomae.build_parser().parse_args(
        _cli_argv(frame_corpus, tmp_path, "--mask_unit_attn", "1", "0", "0", "0"))
    cfg = pretrain_videomae.config_from_args(args)
    m = cfg.model
    assert (m.architecture, m.hidden_size, m.stage_depths, m.stage_heads, m.patch_size) == (
        "hiera", 32, (1, 2, 2, 1), (2, 4, 8, 16), 4)
    assert (m.mask_unit_attn, m.layer_norm_eps, m.q_pool) == (
        (True, False, False, False), 1e-6, 2)
    assert cfg.mask.sampler == "mask_unit" and cfg.data.tubelet_size == 2
    plain = pretrain_videomae.config_from_args(pretrain_videomae.build_parser().parse_args([]))
    assert (plain.model.architecture, plain.mask.sampler, plain.model.stage_depths,
            plain.model.layer_norm_eps) == ("base", "tube", (), 1e-12)


def test_cli_trains_a_hiera_stage_and_extraction_reads_it(frame_corpus, tmp_path):
    summary = pretrain_videomae.main(_cli_argv(frame_corpus, tmp_path), device="cpu")
    assert np.isfinite(summary["train_loss"])
    cfg = _cfg()
    fn = make_embed_fn("videomae", summary["checkpoint"], cfg, device="cpu")
    clips = np.random.default_rng(0).integers(0, 256, (2, 4, 64, 64, 3), dtype=np.uint8)
    emb = fn(clips)
    assert emb.shape == (2, 256) and fn.feature_dim == 256 and np.isfinite(emb).all()
    # the unmasked encoder, the mean of the last stage's tokens, a LayerNorm
    # without affine: the reference's encoder over every unit
    ckpt = torch.load(summary["checkpoint"], weights_only=True)["model_state_dict"]
    every = torch.arange(8).expand(2, -1)
    with torch.no_grad():
        last = ref.encoder_stages(ckpt, ref.normalize(torch.from_numpy(clips)), every,
                                  _fields(cfg))[-1]
        want = F.layer_norm(last.reshape(2, -1, 256).mean(1), (256,), eps=1e-6)
    np.testing.assert_allclose(emb, want.numpy(), rtol=1e-4, atol=1e-4)
    assert untrained_embed_fn("videomae", cfg, device="cpu")(clips).shape == (2, 256)


def test_curriculum_runs_a_hiera_stage(frame_corpus, tmp_path):
    from bvc_tpu_torch.curriculum.driver import build_stage_config, stage_plan
    from bvc_tpu_torch.curriculum.presets import FAMILY_PRESETS

    preset = dataclasses.replace(FAMILY_PRESETS["generative"], n_epoch=1, max_epoch_iters=2,
                                 n_trainsamples=16, batch_size=2, num_frames=4, tubelet_size=2,
                                 mask_ratio=0.5)
    base = TrainConfig(savedir=str(tmp_path), seed=0)
    base.model = _cfg()
    base.data.jpg_root, base.data.image_size = frame_corpus, 64
    base.data.segment_minutes, base.data.num_workers = 0.02, 2
    stage = build_stage_config(preset, stage_plan("dev", preset, 0, n_stages=1)[0], base)
    assert stage.mask.sampler == "mask_unit" and stage.model.layer_norm_eps == 1e-6
    from bvc_tpu_torch.curriculum.driver import run_curriculum

    results = run_curriculum("dev", preset, base, n_stages=1, device="cpu")
    ckpt = results["final_checkpoint"]
    assert np.isfinite(results["stages"][0]["train_loss"])
    emb = make_embed_fn("videomae", ckpt, stage.model, device="cpu")(
        np.zeros((1, 4, 64, 64, 3), np.uint8))
    assert emb.shape == (1, 256) and np.isfinite(emb).all()


@pytest.mark.parametrize("mesh,sharding,match", [
    ({"data": 1, "seq": 2}, "replicated", "'seq' mesh"),
    ({"data": 1, "pipe": 2}, "replicated", "'pipe' mesh"),
    ({}, "tp", "param_sharding tp"),
])
def test_layouts_without_a_hiera_piece_refuse(mesh, sharding, match, tmp_path):
    cfg = TrainConfig(savedir=str(tmp_path), mesh_shape=mesh, param_sharding=sharding)
    cfg.model = _cfg()
    cfg.mask = MaskConfig(sampler="mask_unit", mask_ratio=0.5)
    with pytest.raises(ValueError, match=match):
        trainer_videomae.run_pretraining(cfg, device="cpu")


def test_export_and_int8_refuse_hiera():
    cfg = _cfg()
    with pytest.raises(ValueError, match="'hiera' is not exported"):
        export_embed("videomae", HieraEncoder(cfg), cfg, device="cpu")
    with pytest.raises(ValueError, match="no W8A8 path"):
        untrained_embed_fn("videomae", cfg, device="cpu", quantize="int8")
    with pytest.raises(ValueError, match="sequence-parallel Hiera"):
        untrained_embed_fn("videomae", cfg, device="cpu", mesh_shape={"data": 1, "seq": 2})


@pytest.mark.parametrize("mode", ["replicated", "zero1", "fsdp"])
def test_data_parallel_layouts_take_a_hiera_step(mode):
    """In one process each layout is the one-process state; the step runs
    under each flag Hiera takes."""
    cfg = _cfg()
    state = TrainState.create(HieraMAE(cfg, seed=1), OptimConfig(lr=LR), device="cpu",
                              param_sharding=mode)
    out = make_videomae_train_step(cfg, MaskConfig(sampler="mask_unit", mask_ratio=0.5))(
        state, _video(2, 9))
    assert np.isfinite(out["loss"].item()) and out["grad_ell"].item() > 0
