"""V-JEPA 2 on the port's JEPA path, on the CPU: the rotary JEPA against the
plain reference (``tests/reference_vjepa2.py``), the 3-D multi-block
collator, 16-frame clips from the predictive dataset, the CLI's flags, the
extraction entry, the refusals, and the ViT-B JEPA step unchanged with the
default ``pos_embed``.

The tiny model: 2 layers 96 wide with 6 heads of width 16 (the rotary
segments 4 channels each, the last 4 channels unrotated), a predictor 48
wide with 3 heads and MLP ratio 4, on a 4 x 4 x 4 grid, in f32.
Tolerances: features 2e-5 relative (and 2e-6 absolute; the target's,
normed to unit scale, 1e-5 absolute), the loss 1e-5 relative; gradients and the
EMA target 1e-4 relative and 1e-6 absolute (the port's LayerNorm and
attention sum in another order than ``F.layer_norm`` and the reference's
einsums).  The ViT-B step: bit for bit, against digests recorded from the
tree before rotary positions were added.
"""

import collections
import copy
import hashlib

import numpy as np
import pytest
import torch

import reference_vjepa2 as ref
from bvc_tpu_torch.cli import pretrain_jepa
from bvc_tpu_torch.data.datasets import ClipDataset
from bvc_tpu_torch.data.factory import make_predictive_dataset
from bvc_tpu_torch.evalbench.extract import make_embed_fn, untrained_embed_fn
from bvc_tpu_torch.masks.multiblock import mask_collate
from bvc_tpu_torch.masks.multiblock3d import MultiBlock3DMaskCollator, mask_collate_3d
from bvc_tpu_torch.models.jepa import JEPA, JEPAEncoder, target_features
from bvc_tpu_torch.models.videomae import VideoMAEPretrain
from bvc_tpu_torch.models.vit import block_attention_probs
from bvc_tpu_torch.serving.export import export_embed
from bvc_tpu_torch.training import trainer_jepa
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.steps import make_jepa_train_step
from bvc_tpu_torch.utils.config import (DataConfig, MaskConfig, ModelConfig, OptimConfig,
                                        TrainConfig)

TINY = dict(family="jepa", image_size=64, patch_size=16, num_frames=8, tubelet_size=2,
            hidden_size=96, depth=2, num_heads=6, mlp_ratio=4.0, pred_depth=2,
            pred_emb_dim=48, pred_num_heads=3, pred_mlp_ratio=4.0, pos_embed="rope3d",
            dtype="float32")
MASK = dict(sampler="multiblock3d", pred_mask_scale=(0.3, 0.3), num_pred_masks=1,
            pred_num_blocks=2)
LR, MOMENTUM, EMA, TOTAL = 0.05, 0.9, (0.996, 1.0), 10
B = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(model: torch.nn.Module, seed: int = 0) -> dict:
    """The model's weights moved off their initial zeros and ones, so that
    every leaf has a gradient of its own."""
    gen = torch.Generator().manual_seed(seed)
    return {k: v + 0.05 * torch.randn(v.shape, generator=gen)
            for k, v in model.state_dict().items()}


def _batches(n: int) -> list[dict]:
    collate = mask_collate_3d(ModelConfig(**TINY), MaskConfig(**MASK), seed=7)
    rng = np.random.default_rng(1)
    return [{"video": torch.from_numpy(rng.integers(0, 256, (B, 8, 64, 64, 3), dtype=np.uint8)),
             **{k: torch.from_numpy(v) for k, v in collate(B, i).items()}} for i in range(n)]


def _port(params: dict, cfg: ModelConfig):
    model = JEPA(cfg)
    model.load_state_dict(params)
    state = TrainState.create(model, OptimConfig(name="sgd", lr=LR, momentum=MOMENTUM,
                                                 nesterov=True, weight_decay=0.0),
                              device="cpu", target=copy.deepcopy(model.encoder))
    return state, make_jepa_train_step(cfg, TOTAL, ema=EMA)


def test_rotary_jepa_matches_the_reference():
    cfg = ModelConfig(**TINY)
    params = _perturbed(JEPA(cfg, seed=2))
    batches = _batches(2)
    b0 = batches[0]
    state, step = _port(params, cfg)
    with torch.no_grad():
        got = state.model.encoder(b0["video"], b0["enc_idx"])
        want = ref.encode(params, "encoder.", b0["video"], cfg, b0["enc_idx"])
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
        pred = b0["pred_idx"].transpose(0, 1)
        target = {k[len("encoder."):]: v for k, v in params.items() if k.startswith("encoder.")}
        torch.testing.assert_close(target_features(state.target, b0["video"], pred, "auto")[0],
                                   ref.target_features(target, b0["video"], pred[0], cfg),
                                   rtol=2e-5, atol=1e-5)
    want_steps = ref.train(params, batches, cfg, LR, MOMENTUM, EMA, TOTAL)
    names = [n for n, _ in state.model.named_parameters()]
    assert set(names) == set(params)  # no position table among the leaves
    for i, (batch, w) in enumerate(zip(batches, want_steps)):
        loss = step(state, batch)["loss"].item()
        np.testing.assert_allclose(loss, w["loss"], rtol=1e-5)
        if i == 0:  # the momentum buffer after one step is the gradient
            for name, p in state.model.named_parameters():
                torch.testing.assert_close(state.optimizer.state[p]["momentum_buffer"],
                                           w["grads"][name], rtol=1e-4, atol=1e-6, msg=name)
    for name, p in state.target.named_parameters():
        torch.testing.assert_close(p.detach(), want_steps[-1]["target"][name], rtol=1e-4,
                                   atol=1e-6, msg=name)
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(p.detach(), want_steps[-1]["params"][name], rtol=1e-4,
                                   atol=1e-6, msg=name)


def test_positions_matter():
    """Rotations left out, or the context read at positions 0 .. Ke-1, give
    other features: the reference's check is not blind to them."""
    cfg = ModelConfig(**TINY)
    model = JEPA(cfg, seed=2)
    model.load_state_dict(_perturbed(model))
    b0 = _batches(1)[0]
    with torch.no_grad():
        base = model.encoder(b0["video"], b0["enc_idx"])
        shifted = model.encoder(b0["video"], torch.arange(b0["enc_idx"].shape[1]).expand(B, -1))
        sincos = JEPAEncoder(ModelConfig(**{**TINY, "pos_embed": "sincos3d"}))
    assert (base - shifted).abs().max() > 1e-3
    assert "pos_embed" in dict(sincos.named_buffers())
    assert "pos_embed" not in dict(model.encoder.named_buffers())
    assert "pos_embed" not in dict(model.predictor.named_buffers())


def test_predictor_takes_its_own_heads_and_mlp():
    model = JEPA(ModelConfig(**{**TINY, "mlp_ratio": 48 / 11}))
    assert model.predictor.blocks.layers[0].num_heads == 3
    assert model.predictor.blocks.layers[0].fc1.out_features == 48 * 4
    assert model.encoder.blocks.layers[0].fc1.out_features == int(96 * 48 / 11)
    default = JEPA(ModelConfig(**{**TINY, "pred_num_heads": 0, "pred_mlp_ratio": 0.0}))
    assert default.predictor.blocks.layers[0].num_heads == 6
    assert default.predictor.blocks.layers[0].fc1.out_features == 4 * 48


# -- the 3-D collator ------------------------------------------------------------


@pytest.mark.parametrize("grid,scale,blocks", [((8, 16, 16), (0.15, 0.15), 8),
                                               ((4, 4, 4), (0.3, 0.3), 2),
                                               ((2, 6, 5), (0.2, 0.4), 3)])
def test_collator_union_and_complement(grid, scale, blocks):
    col = MultiBlock3DMaskCollator(grid=grid, scale=scale, num_blocks=blocks, seed=11)
    T, H, W = grid
    for step in range(4):
        enc, pred = col(6, step)
        assert enc.dtype == pred.dtype == np.int32
        assert enc.shape[0] == pred.shape[0] == 6 and enc.shape[1] > 0 and pred.shape[1] > 0
        for e, p in zip(enc, pred):
            assert len(set(e)) == len(e) and len(set(p)) == len(p)
            assert not set(e) & set(p)  # disjoint
            assert np.all(np.diff(e) > 0) and np.all(np.diff(p) > 0)
        assert enc.shape[1] + pred.shape[1] <= T * H * W
        assert enc.max() < T * H * W and pred.max() < T * H * W
    again = MultiBlock3DMaskCollator(grid=grid, scale=scale, num_blocks=blocks, seed=11)
    for step in range(2):
        a, b = col(6, step), again(6, step)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    other = MultiBlock3DMaskCollator(grid=grid, scale=scale, num_blocks=blocks, seed=12)
    assert not all(np.array_equal(x, y) for x, y in zip(col(6, 0), other(6, 0)))


def test_collator_uncut_rows_cover_the_grid():
    """One clip alone is never cut: its context and targets split the grid."""
    grid = (8, 16, 16)
    col = MultiBlock3DMaskCollator(grid=grid, scale=(0.15, 0.15), num_blocks=8, seed=3)
    for step in range(5):
        enc, pred = col(1, step)
        assert sorted(np.concatenate([enc[0], pred[0]]).tolist()) == list(range(8 * 256))
        covered = np.zeros(256, bool)
        covered[pred[0][pred[0] < 256]] = True
        assert set(pred[0].tolist()) == {t * 256 + i for t in range(8)
                                         for i in np.flatnonzero(covered)}


def test_collator_counts_are_equal_across_the_batch():
    collate = mask_collate_3d(ModelConfig(**{**TINY, "image_size": 256, "num_frames": 16}),
                              MaskConfig(sampler="multiblock3d", pred_mask_scale=(0.15, 0.15),
                                         num_pred_masks=1), seed=5)
    out = collate(16, 3)
    assert out["enc_idx"].shape[0] == 16 and out["pred_idx"].shape[:2] == (16, 1)
    assert (out["enc_idx"] >= 0).all() and (out["pred_idx"] >= 0).all()  # no padding
    assert 250 < out["enc_idx"].shape[1] < 1000 and out["pred_idx"].shape[2] > 1000
    with pytest.raises(ValueError, match="one prediction mask"):
        mask_collate_3d(ModelConfig(**TINY), MaskConfig(sampler="multiblock3d"), seed=0)


def test_trainer_collate_takes_this_ranks_rows(monkeypatch):
    cfg = TrainConfig(seed=4)
    cfg.model, cfg.mask = ModelConfig(**TINY), MaskConfig(**MASK)
    collate, collator = trainer_jepa.make_mask_collate(cfg, batches_per_epoch=10)
    whole = mask_collate_3d(cfg.model, cfg.mask, seed=4)(4, 13)
    monkeypatch.setattr(trainer_jepa, "data_size", lambda: 2)
    monkeypatch.setattr(trainer_jepa, "data_rank", lambda: 1)
    out = collate(np.zeros((2, 8, 64, 64, 3), np.uint8), epoch=1, batch_idx=3)
    assert np.array_equal(out["enc_idx"], whole["enc_idx"][2:])
    assert np.array_equal(out["pred_idx"], whole["pred_idx"][2:])
    assert collator.state_dict() == {"step": 13, "seed": 4}


# -- data, CLI, extraction -------------------------------------------------------


def test_predictive_dataset_gives_clips(frame_corpus):
    cfg = DataConfig(jpg_root=frame_corpus, num_frames=8, tubelet_size=2, image_size=32,
                     n_trainsamples=20, segment_minutes=0.02)
    ds = make_predictive_dataset(cfg)["train"]
    assert isinstance(ds, ClipDataset) and len(ds) == 20
    assert ds[(3, np.random.default_rng(0))].shape == (8, 32, 32, 3)
    pairs = make_predictive_dataset(DataConfig(jpg_root=frame_corpus, image_size=32,
                                               num_frames=2, tubelet_size=1, interval=5,
                                               n_trainsamples=20, segment_minutes=0.02))
    assert not isinstance(pairs["train"], ClipDataset)


def _cli_argv(frame_corpus, savedir, *extra):
    return ["-jpg_root", frame_corpus, "-savedir", str(savedir), "--batch_size", "2",
            "--n_trainsamples", "16", "--max_epoch_iters", "2", "--segment_minutes", "0.02",
            "--num_workers", "2", "--run_id", "dev_1_g0_default_0_0", "--image_size", "64",
            "--architecture", "tiny", "--num_frames", "8", "--tubelet_size", "2",
            "--pred_emb_dim", "48", "--pred_depth", "1", "--pos_embed", "rope3d",
            "--num_heads", "6", "--pred_num_heads", "3", "--mask_sampler", "multiblock3d",
            "--pred_mask_scale", "0.3", "--pred_num_blocks", "2", *extra]


def test_cli_flags(frame_corpus, tmp_path):
    args = pretrain_jepa.build_parser().parse_args(_cli_argv(frame_corpus, tmp_path,
                                                             "--mlp_ratio", "4.363636363636363",
                                                             "--pred_mlp_ratio", "4"))
    cfg = pretrain_jepa.config_from_args(args)
    m, k = cfg.model, cfg.mask
    assert (m.pos_embed, m.num_heads, m.pred_num_heads, m.mlp_ratio, m.pred_mlp_ratio) == (
        "rope3d", 6, 3, 4.363636363636363, 4.0)
    assert (k.sampler, k.pred_mask_scale, k.num_pred_masks, k.pred_num_blocks) == (
        "multiblock3d", (0.3, 0.3), 1, 2)
    plain = pretrain_jepa.config_from_args(pretrain_jepa.build_parser().parse_args(
        ["-jpg_root", "x", "-savedir", "y", "--architecture", "tiny"]))
    assert (plain.model.pos_embed, plain.model.num_heads, plain.model.mlp_ratio,
            plain.mask.sampler) == ("sincos3d", 3, 4.0, "tube")


def test_cli_trains_a_rotary_stage_and_extraction_reads_it(frame_corpus, tmp_path):
    summary = pretrain_jepa.main(_cli_argv(frame_corpus, tmp_path), device="cpu")
    ckpt = torch.load(summary["checkpoint"], weights_only=True)
    assert "pos_embed" not in ckpt["encoder"] and "predictor_pos_embed" not in ckpt["predictor"]
    assert np.isfinite(summary["train_loss"])
    cfg = ModelConfig(family="jepa", architecture="vit_tiny", hidden_size=192, depth=12,
                      num_heads=6, num_frames=8, tubelet_size=2, image_size=64,
                      pred_depth=1, pred_emb_dim=48, pred_num_heads=3, pos_embed="rope3d")
    fn = make_embed_fn("jepa", summary["checkpoint"], cfg, device="cpu")
    clips = np.random.default_rng(0).integers(0, 256, (2, 8, 64, 64, 3), dtype=np.uint8)
    emb = fn(clips)
    assert emb.shape == (2, 192) and np.isfinite(emb).all()
    with torch.no_grad():
        want = fn.model.embed(torch.from_numpy(clips)).numpy()
    np.testing.assert_array_equal(emb, want)
    assert untrained_embed_fn("jepa", cfg, device="cpu")(clips).shape == (2, 192)


# -- refusals ----------------------------------------------------------------------


@pytest.mark.parametrize("axis", ["seq", "pipe"])
def test_seq_and_pipe_meshes_refuse_rope(axis, tmp_path):
    cfg = TrainConfig(savedir=str(tmp_path), mesh_shape={"data": 1, axis: 2})
    cfg.model = ModelConfig(**TINY)
    with pytest.raises(ValueError, match=f"rope3d' on a '{axis}' mesh"):
        trainer_jepa.run_pretraining(cfg, device="cpu")


def test_a_time_slice_is_refused():
    enc = JEPAEncoder(ModelConfig(**TINY))
    video = torch.zeros((1, 4, 64, 64, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="'seq' mesh"):
        enc(video, token_offset=0)
    with pytest.raises(ValueError, match="token grid"):
        enc(torch.zeros((1, 8, 32, 32, 3), dtype=torch.uint8))


def test_export_refuses_rope():
    cfg = ModelConfig(**TINY)
    with pytest.raises(ValueError, match="rope3d"):
        export_embed("jepa", JEPAEncoder(cfg), cfg, device="cpu")


def test_other_refusals():
    with pytest.raises(ValueError, match="rotary positions"):
        VideoMAEPretrain(ModelConfig(pos_embed="rope3d", hidden_size=32, depth=1,
                                     num_heads=2, decoder_depth=1, decoder_hidden_size=16,
                                     decoder_num_heads=2))
    with pytest.raises(ValueError, match="unknown pos_embed"):
        JEPAEncoder(ModelConfig(**{**TINY, "pos_embed": "learned"}))
    block = JEPAEncoder(ModelConfig(**TINY)).blocks.layers[0]
    with pytest.raises(ValueError, match="rope_grid"):
        block_attention_probs(block, torch.zeros((1, 4, 96)))


@pytest.mark.parametrize("mode", ["replicated", "zero1", "fsdp", "tp"])
def test_every_parameter_layout_takes_a_rotary_step(mode):
    """In one process each layout is the one-process state; the step runs
    with every layout's flag (RoPE is per head: the split of heads under
    ``tp`` keeps each head whole)."""
    cfg = ModelConfig(**TINY)
    model = JEPA(cfg, seed=1)
    state = TrainState.create(model, OptimConfig(lr=LR), device="cpu",
                              target=copy.deepcopy(model.encoder), param_sharding=mode)
    out = make_jepa_train_step(cfg, TOTAL)(state, _batches(1)[0])
    assert np.isfinite(out["loss"].item())


# -- the ViT-B JEPA step with the default positions --------------------------------

# sha256 of the losses and the state after two steps, and of the profiled
# operator names of one step, recorded from the tree before rotary positions
# were added (torch 2.x on the CPU, one thread)
STEP_DIGEST = {"bfloat16": "de09870396d5df46c6552ae414a49e556f9cb8c0b59d9b5be17fa4b15fc0be82",
               "float32": "7c84c7153d7d628b9c9db11b0441d0b3e4e2ccd05c8484b96dbf15eb74503628"}
OPS = {"bfloat16": (6110, "a46b32d9bba6c8a0"), "float32": (4558, "9b1f05fe03daf9d0")}


def _vit_b_like(dtype):
    cfg = ModelConfig(family="jepa", image_size=64, patch_size=16, num_frames=2, tubelet_size=1,
                      hidden_size=64, depth=2, num_heads=2, pred_depth=1, pred_emb_dim=32,
                      dtype=dtype)
    model = JEPA(cfg, seed=3)
    state = TrainState.create(model, OptimConfig(lr=0.03), device="cpu",
                              target=copy.deepcopy(model.encoder))
    collate = mask_collate(cfg, MaskConfig(pred_mask_scale=(0.15, 0.2), min_keep=2), seed=0)
    rng = np.random.default_rng(0)
    batches = [{"video": torch.from_numpy(rng.integers(0, 256, (4, 2, 64, 64, 3),
                                                        dtype=np.uint8)),
                **{k: torch.from_numpy(v) for k, v in collate(4, step=i).items()}}
               for i in range(2)]
    return state, make_jepa_train_step(cfg, 10), batches


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_default_positions_leave_the_jepa_step_bit_for_bit(dtype):
    state, step, batches = _vit_b_like(dtype)
    h = hashlib.sha256()
    for batch in batches:
        h.update(step(state, batch)["loss"].float().numpy().tobytes())
    for t in list(state.model.state_dict().values()) + list(state.target.state_dict().values()):
        h.update(t.float().numpy().tobytes())
    assert h.hexdigest() == STEP_DIGEST[dtype]
    state, step, batches = _vit_b_like(dtype)
    with torch.profiler.profile() as prof:
        step(state, batches[0])
    names = sorted(collections.Counter(e.name for e in prof.events()).items())
    assert (sum(n for _, n in names),
            hashlib.sha256(repr(names).encode()).hexdigest()[:16]) == OPS[dtype]
