"""The port's JEPA modules against the JAX package at a tiny size, in f32:
the 3-D position table, the multi-block collator, ``encoder_forward``
(masked and full), ``predictor_forward``, ``target_features`` and ``embed``
from the same weights (carried by ``jepa_from_jax_params``), and the
``.pth.tar`` reference-layout round trip through ``make_embed_fn``.

The encoder is 128 wide with 2 heads (head width 64), the predictor 64 wide
with 2 heads (head width 32): the widths of the two key-bias kernels.
Tolerances: the position table 1e-6; model outputs 1e-5 absolute and
relative, as ``tests/test_jepa.py`` holds its padding test, since the two
sides differ only in summation order; the collator's indices exactly.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.masks.multiblock import MultiBlockMaskCollator as JaxCollator
from bvc_tpu.masks.multiblock import update_mask_indices as jax_update_mask_indices
from bvc_tpu.models import jepa as jax_jepa
from bvc_tpu.models.posenc import positional_encoding_3d as jax_posenc_3d
from bvc_tpu.models.torch_interop import jepa_encoder_to_reference
from bvc_tpu.training.trainer_jepa import make_mask_collate as jax_make_mask_collate
from bvc_tpu.utils.config import MaskConfig as JaxMaskConfig
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu.utils.config import TrainConfig as JaxTrainConfig
from bvc_tpu_torch.evalbench.extract import make_embed_fn, untrained_embed_fn
from bvc_tpu_torch.masks.multiblock import (MultiBlockMaskCollator, mask_collate,
                                            update_mask_indices)
from bvc_tpu_torch.models.convert import (jepa_encoder_from_jax_params,
                                          jepa_encoder_from_reference_state_dict,
                                          jepa_from_jax_params)
from bvc_tpu_torch.models.jepa import JEPA, JEPAEncoder, target_features
from bvc_tpu_torch.models.posenc import positional_encoding_3d
from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig

TINY = dict(family="jepa", image_size=32, patch_size=8, num_frames=2, tubelet_size=1,
            hidden_size=128, depth=2, num_heads=2, mlp_ratio=2.0, pred_depth=1,
            pred_emb_dim=64, dtype="float32")
MASK = dict(enc_mask_scale=(0.85, 1.0), pred_mask_scale=(0.2, 0.25), num_pred_masks=2,
            min_keep=2)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(**cfg_kw):
    """JAX config and params (perturbed off their init so no tensor is
    trivially zero), the port's JEPA on the same weights, a clip batch and
    the collator's indices for it."""
    jcfg = JaxModelConfig(**{**TINY, **cfg_kw})
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32),
        jax_jepa.init_params(jax.random.PRNGKey(0), jcfg))
    model = JEPA(ModelConfig(**{**TINY, **cfg_kw}))
    model.load_state_dict(jepa_from_jax_params(tree, model.cfg))
    video = rng.standard_normal((3, 2, 32, 32, 3)).astype(np.float32)
    batch = mask_collate(model.cfg, MaskConfig(**MASK), seed=0)(3, step=0)
    return jcfg, tree, model, video, batch


def _close(ours: torch.Tensor, ref, tol=TOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("grid,channels", [((2, 4, 4), 128), ((2, 4, 4), 64),
                                           ((1, 14, 14), 768), ((2, 14, 14), 384),
                                           ((3, 5, 7), 30)])
def test_positional_encoding_3d_matches_jax(grid, channels):
    ours = positional_encoding_3d(*grid, channels)
    ref = jax_posenc_3d(*grid, channels)
    assert ours.shape == ref.shape == (int(np.prod(grid)), channels)
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("allow_overlap", [False, True], ids=["disjoint", "overlap"])
@pytest.mark.parametrize("step", [0, 1, 7])
def test_collator_matches_jax(step, allow_overlap):
    kw = dict(input_size=224, patch_size=16, enc_mask_scale=(0.85, 1.0),
              pred_mask_scale=(0.1, 0.15), aspect_ratio=(0.75, 1.5), nenc=1, npred=4,
              min_keep=10, allow_overlap=allow_overlap, seed=3)
    ours, ref = MultiBlockMaskCollator(**kw), JaxCollator(**kw)
    # the configuration of the slice: caps 169 and 30
    assert (ours.enc_cap, ours.pred_cap) == (ref.enc_cap, ref.pred_cap) == (169, 30)
    for a, b in zip(ours(6, step=step), ref(6, step=step)):
        np.testing.assert_array_equal(a, b)
        for enc in (True, False):
            np.testing.assert_array_equal(update_mask_indices(a, 224, 16, 2, 1, enc),
                                          jax_update_mask_indices(b, 224, 16, 2, 1, enc))
    # the internal counter advances as the JAX one does
    for _ in range(2):
        for a, b in zip(ours(2), ref(2)):
            np.testing.assert_array_equal(a, b)


def test_mask_collate_matches_jax_trainer():
    cfg = JaxTrainConfig(seed=5)
    cfg.model = JaxModelConfig(**TINY)
    cfg.mask = JaxMaskConfig(**MASK)
    jax_collate, _ = jax_make_mask_collate(cfg, batches_per_epoch=10)
    collate = mask_collate(ModelConfig(**TINY), MaskConfig(**MASK), seed=5)
    video = np.zeros((4, 2, 32, 32, 3), np.float32)
    for epoch, batch_idx in ((0, 0), (0, 3), (2, 1)):
        ref = jax_collate(video, epoch, batch_idx)
        ours = collate(4, step=epoch * 10 + batch_idx)
        for key in ("enc_idx", "pred_idx"):
            np.testing.assert_array_equal(ours[key], ref[key])
    assert ours["pred_idx"].shape == (4, 2, collate.collator.pred_cap)
    with pytest.raises(NotImplementedError, match="nenc"):
        mask_collate(ModelConfig(**TINY), MaskConfig(**MASK, num_enc_masks=2))


@pytest.mark.parametrize("attn_impl", ["auto", "flash"])
def test_encoder_masked_and_full_match_jax(attn_impl):
    jcfg, tree, model, video, batch = _setup()
    jv = jnp.asarray(video)
    full = model.encoder(torch.from_numpy(video), attn_impl=attn_impl)
    assert full.shape == (3, 32, 128)
    _close(full, jax_jepa.encoder_forward(tree["encoder"], jv, jcfg))
    keep = batch["enc_idx"]
    assert (keep < 0).any() or keep.shape[1] < 16  # some padding or a cut
    masked = model.encoder(torch.from_numpy(video), torch.from_numpy(keep), attn_impl)
    assert masked.shape == (3, keep.shape[1], 128)
    _close(masked, jax_jepa.encoder_forward(tree["encoder"], jv, jcfg, jnp.asarray(keep)))


def test_encoder_padding_is_invisible():
    _, _, model, video, _ = _setup()
    x = torch.from_numpy(video[:1])
    padded = model.encoder(x, torch.tensor([[3, 7, 9, -1]]), "flash")
    exact = model.encoder(x, torch.tensor([[3, 7, 9]]), "flash")
    torch.testing.assert_close(padded[:, :3], exact, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("attn_impl", ["auto", "flash"])
def test_predictor_matches_jax(attn_impl):
    jcfg, tree, model, video, batch = _setup()
    enc_idx, pred_idx = batch["enc_idx"], batch["pred_idx"].transpose(1, 0, 2)
    rng = np.random.default_rng(1)
    z = rng.standard_normal((3, enc_idx.shape[1], 128)).astype(np.float32)
    ours = model.predictor(torch.from_numpy(z), torch.from_numpy(enc_idx),
                           torch.from_numpy(pred_idx), attn_impl)
    ref = jax_jepa.predictor_forward(tree["predictor"], jnp.asarray(z), jnp.asarray(enc_idx),
                                     jnp.asarray(pred_idx), jcfg)
    assert ours.shape == (2, 3, pred_idx.shape[2], 128)
    _close(ours, ref)


@pytest.mark.parametrize("target_score_bf16", [True, False], ids=["bf16_scores", "f32"])
def test_target_features_match_jax(target_score_bf16):
    jcfg, tree, model, video, batch = _setup(target_score_bf16=target_score_bf16)
    pred_idx = batch["pred_idx"].transpose(1, 0, 2)
    target = copy.deepcopy(model.encoder).requires_grad_(False)
    # the JAX function picks 'xla_bf16' from the config itself
    impl = "xla_bf16" if target_score_bf16 else "auto"
    ours = target_features(target, torch.from_numpy(video), torch.from_numpy(pred_idx), impl)
    ref = jax_jepa.target_features(tree["encoder"], jnp.asarray(video),
                                   jnp.asarray(pred_idx), jcfg)
    assert ours.shape == (2, 3, pred_idx.shape[2], 128) and ours.grad_fn is None
    _close(ours, ref)


def test_embed_matches_jax():
    jcfg, tree, model, video, _ = _setup()
    ours = model.encoder.embed(torch.from_numpy(video))
    assert ours.shape == (3, 128) and ours.dtype == torch.float32
    _close(ours, jax_jepa.embed(tree["encoder"], jnp.asarray(video), jcfg))


def test_reference_layout_round_trip(tmp_path):
    # what export_torch writes for a JEPA checkpoint, read by make_embed_fn
    jcfg, tree, model, video, _ = _setup()
    ref_sd = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in jepa_encoder_to_reference(tree["encoder"], jcfg).items()}
    cfg = model.cfg
    from_ref = jepa_encoder_from_reference_state_dict(ref_sd, cfg)
    from_jax = jepa_encoder_from_jax_params(tree["encoder"], cfg)
    assert from_ref.keys() == from_jax.keys() == model.encoder.state_dict().keys()
    for k in from_ref:
        torch.testing.assert_close(from_ref[k], from_jax[k], rtol=0, atol=0)
    path = tmp_path / "model_dev_1_g0_default_0_0.pth.tar"
    torch.save({"encoder": ref_sd, "predictor": {}, "target_encoder": ref_sd}, path)
    fn = make_embed_fn("jepa", str(path), cfg, device="cpu")
    clips = np.random.default_rng(2).integers(0, 256, (2, 2, 32, 32, 3), dtype=np.uint8)
    out = fn(clips)
    assert out.shape == (2, 128) and fn.feature_dim == 128
    ref = jax_jepa.embed(tree["encoder"], jnp.asarray(clips), jcfg)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=TOL, atol=TOL)


def test_checkpoint_without_encoder_reads_target_encoder(tmp_path):
    # as bvc_tpu.evalbench.extract reads it: the EMA target where the
    # checkpoint kept no online encoder
    jcfg, tree, model, _, _ = _setup()
    ref_sd = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in jepa_encoder_to_reference(tree["encoder"], jcfg).items()}
    clips = np.random.default_rng(3).integers(0, 256, (2, 2, 32, 32, 3), dtype=np.uint8)
    outs = {}
    for key in ("encoder", "target_encoder"):
        path = tmp_path / f"{key}.pth.tar"
        torch.save({key: ref_sd, "predictor": {}}, path)
        outs[key] = make_embed_fn("jepa", str(path), model.cfg, device="cpu")(clips)
    np.testing.assert_array_equal(outs["target_encoder"], outs["encoder"])
    ref = jax_jepa.embed(tree["encoder"], jnp.asarray(clips), jcfg)
    np.testing.assert_allclose(outs["target_encoder"], np.asarray(ref), rtol=TOL, atol=TOL)


def test_untrained_embed_fn_and_unported_options():
    cfg = ModelConfig(**TINY)
    fn = untrained_embed_fn("jepa", cfg, seed=0, device="cpu")
    out = fn(np.zeros((2, 2, 32, 32, 3), np.uint8))
    assert out.shape == (2, 128) and np.isfinite(out).all()
    # the same seed gives the same encoder as JEPA(cfg, seed)'s
    enc = JEPAEncoder(cfg, seed=0)
    for (n, a), b in zip(JEPA(cfg, seed=0).encoder.state_dict().items(),
                         enc.state_dict().values()):
        assert torch.equal(a, b), n
    # another spatial grid reads the resized position table (held to JAX's
    # in test_torch_unported.py); drop-path runs only with a generator
    # (training): without one the forward is unchanged
    assert enc(torch.zeros(1, 2, 48, 48, 3)).shape == (1, 2 * 6 * 6, 128)
    with pytest.raises(ValueError, match="time grid"):
        enc(torch.zeros(1, 4, 32, 32, 3))
    dropping = JEPA(ModelConfig(**TINY, drop_path_rate=0.1), seed=0).encoder
    video = torch.randint(0, 256, (2, 2, 32, 32, 3), dtype=torch.uint8)
    with torch.no_grad():
        assert torch.equal(dropping(video), enc(video))
        gen = torch.Generator().manual_seed(0)
        assert not torch.equal(dropping(video, generator=gen), enc(video))
