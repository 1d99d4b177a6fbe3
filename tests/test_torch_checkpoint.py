"""The port's checkpoints: ``model_{run_id}.pth.tar`` in the layout
``bvc_tpu/cli/export_torch.py`` exports, loadable with
``weights_only=True``, the ``.new``/``.old`` swap, ``load_meta``, the async
writer, and the conversions against ``bvc_tpu.models.torch_interop``.

Tolerances: state dicts and round trips exact (``torch.equal``); a port
checkpoint read by ``bvc_tpu.models.torch_interop`` embeds the same clips
in JAX as ``make_embed_fn`` does in the port within
``tests/test_torch_videomae_embed.py``'s f32 tolerance, max abs 1e-4 (JEPA:
``tests/test_torch_jepa.py``'s 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.models import jepa as jax_jepa
from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.models.torch_interop import (jepa_encoder_to_reference as jax_enc_to_ref,
                                          jepa_predictor_to_reference as jax_pred_to_ref,
                                          load_reference_checkpoint,
                                          load_reference_jepa_checkpoint,
                                          videomae_to_hf_state_dict)
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu_torch.evalbench.extract import make_embed_fn
from bvc_tpu_torch.models.convert import (jepa_encoder_from_reference_state_dict,
                                          jepa_encoder_to_reference, jepa_from_jax_params,
                                          jepa_predictor_from_reference_state_dict,
                                          jepa_predictor_to_reference, qkv_key_biases,
                                          videomae_pretrain_from_hf_state_dict,
                                          videomae_pretrain_from_jax_params,
                                          videomae_pretrain_to_hf_state_dict,
                                          with_qkv_key_biases)
from bvc_tpu_torch.models.jepa import JEPA
from bvc_tpu_torch.models.videomae import VideoMAEPretrain
from bvc_tpu_torch.training import checkpoint
from bvc_tpu_torch.training.async_checkpoint import AsyncCheckpointWriter
from bvc_tpu_torch.training.checkpoint import (checkpoint_exists, checkpoint_path,
                                               load_checkpoint, load_meta,
                                               load_optimizer_state, save_checkpoint)
from bvc_tpu_torch.training.state import TrainState
from bvc_tpu_torch.training.trainer_jepa import run_pretraining as run_jepa
from bvc_tpu_torch.training.trainer_videomae import run_pretraining as run_videomae
from bvc_tpu_torch.utils.config import ModelConfig, OptimConfig, TrainConfig
from torch_tiny_runs import JEPA_MODEL, VIDEOMAE_MODEL, tiny_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(tree, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32), tree)


def _state(tmp_steps=2):
    """A port train state after ``tmp_steps`` SGD updates (momentum set)."""
    model = VideoMAEPretrain(ModelConfig(**VIDEOMAE_MODEL), seed=3)
    state = TrainState.create(model, OptimConfig(lr=0.05), seed=7, device="cpu")
    for _ in range(tmp_steps):
        loss = sum(p.square().sum() for p in state.model.parameters())
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
    torch.rand(5, generator=state.generator)  # move the generator off its seed
    return state


def _save_state(path, state, epoch=1, meta=None):
    save_checkpoint(path, {"model_state_dict": state.model.state_dict(),
                           "opt": state.optimizer.state_dict(), "epoch": epoch,
                           "step": state.step, "rng": state.generator.get_state()},
                    meta=meta)


def test_round_trip_of_model_optimizer_step_and_generator(tmp_path):
    state = _state()
    path = checkpoint_path(tmp_path, "dev_1_g0_default_0_0")
    assert path.name == "model_dev_1_g0_default_0_0.pth.tar"
    _save_state(path, state, meta={"epoch": 1, "loss": np.float32(0.5), "n": np.int64(3)})
    raw = torch.load(path, weights_only=True)  # what recent torch loads by default
    assert raw["meta"] == {"epoch": 1, "loss": 0.5, "n": 3}
    assert type(raw["meta"]["loss"]) is float and type(raw["meta"]["n"]) is int
    fresh = TrainState.create(VideoMAEPretrain(ModelConfig(**VIDEOMAE_MODEL), seed=4),
                              OptimConfig(lr=0.05), seed=8, device="cpu")
    ckpt = load_checkpoint(path)
    fresh.model.load_state_dict(ckpt["model_state_dict"])
    load_optimizer_state(fresh.optimizer, ckpt["opt"])
    fresh.step = ckpt["step"]
    fresh.generator.set_state(ckpt["rng"])
    for (n, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    for a, b in zip(state.optimizer.state_dict()["state"].values(),
                    fresh.optimizer.state_dict()["state"].values()):
        assert torch.equal(a["momentum_buffer"], b["momentum_buffer"])
    assert fresh.step == state.step == 2
    assert torch.equal(torch.rand(4, generator=fresh.generator),
                       torch.rand(4, generator=state.generator))


def test_optimizer_state_keeps_its_own_hyper_parameters():
    state = _state()
    saved = state.optimizer.state_dict()
    other = TrainState.create(VideoMAEPretrain(ModelConfig(**VIDEOMAE_MODEL)),
                              OptimConfig(lr=0.3), device="cpu")
    load_optimizer_state(other.optimizer, saved)
    assert other.optimizer.param_groups[0]["lr"] == 0.3
    assert torch.equal(other.optimizer.state_dict()["state"][0]["momentum_buffer"],
                       saved["state"][0]["momentum_buffer"])


@pytest.mark.parametrize("survivor", [".new", ".old"])
def test_recovery_from_an_interrupted_swap(tmp_path, survivor):
    path = tmp_path / "model_x.pth.tar"
    torch.save({"epoch": 5, "meta": {"epoch": 5}}, path.with_name(path.name + survivor))
    assert not path.exists() and checkpoint_exists(path)
    assert load_checkpoint(path)["epoch"] == 5 and load_meta(path) == {"epoch": 5}
    # a save finishes the swap, then writes; no sibling survives
    save_checkpoint(path, {"epoch": 6}, meta={"epoch": 6})
    assert load_meta(path) == {"epoch": 6}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["model_x.pth.tar"]


def test_a_stale_new_beside_a_complete_checkpoint_is_not_read(tmp_path):
    path = tmp_path / "model_x.pth.tar"
    save_checkpoint(path, {"epoch": 1}, meta={"epoch": 1})
    torch.save({"epoch": 9, "meta": {"epoch": 9}}, path.with_name(path.name + ".new"))
    assert load_meta(path) == {"epoch": 1}
    save_checkpoint(path, {"epoch": 2}, meta={"epoch": 2})
    assert load_checkpoint(path)["epoch"] == 2
    assert not path.with_name(path.name + ".new").exists()
    assert not checkpoint_exists(tmp_path / "model_missing.pth.tar")
    assert load_meta(tmp_path / "model_missing.pth.tar") == {}


def test_load_meta_maps_without_reading_tensors(tmp_path, monkeypatch):
    path = tmp_path / "model_x.pth.tar"
    save_checkpoint(path, {"big": torch.zeros(1000, 1000)}, meta={"epoch": 3, "loss": 0.25})
    calls = []
    real_load = torch.load

    def spy(*args, **kw):
        calls.append(kw)
        return real_load(*args, **kw)

    monkeypatch.setattr(checkpoint.torch, "load", spy)
    assert load_meta(path) == {"epoch": 3, "loss": 0.25}
    assert calls == [{"map_location": "cpu", "weights_only": True, "mmap": True}]


def test_async_writer_snapshots_before_the_next_step(tmp_path):
    state = _state()
    path = tmp_path / "model_a.pth.tar"
    writer = AsyncCheckpointWriter()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    writer.save(path, {"model_state_dict": state.model.state_dict(),
                       "opt": state.optimizer.state_dict()}, meta={"epoch": 1})
    with torch.no_grad():  # the next step mutates the live state at once
        for p in state.model.parameters():
            p.add_(1.0)
        for s in state.optimizer.state.values():
            s["momentum_buffer"].add_(1.0)
    writer.wait()
    saved = load_checkpoint(path)
    assert all(torch.equal(saved["model_state_dict"][k], v) for k, v in before.items())
    assert not writer.in_flight
    # a failed write surfaces at the next wait
    writer.save(tmp_path / "missing_dir" / "model_b.pth.tar", {"x": torch.ones(1)})
    with pytest.raises((FileNotFoundError, RuntimeError)):
        writer.wait()


def test_videomae_hf_layout_matches_torch_interop():
    jcfg = JaxModelConfig(**VIDEOMAE_MODEL)
    tree = _perturbed(jax_videomae.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = ModelConfig(**VIDEOMAE_MODEL)
    sd = videomae_pretrain_from_jax_params(tree, cfg)
    ours = videomae_pretrain_to_hf_state_dict(sd, cfg)
    ref = videomae_to_hf_state_dict(tree, jcfg)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)
    # HF -> port: the pretraining model's whole state dict, the k thirds of
    # the qkv biases from their own entries
    back = with_qkv_key_biases(videomae_pretrain_from_hf_state_dict(ours, cfg),
                               qkv_key_biases(sd))
    model = VideoMAEPretrain(cfg)
    model.load_state_dict(back)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_jepa_reference_layout_matches_torch_interop():
    jcfg = JaxModelConfig(**JEPA_MODEL)
    tree = _perturbed(jax_jepa.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = ModelConfig(**JEPA_MODEL)
    sd = jepa_from_jax_params(tree, cfg)
    enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    pred = {k[len("predictor."):]: v for k, v in sd.items() if k.startswith("predictor.")}
    for ours, ref in ((jepa_encoder_to_reference(enc, cfg), jax_enc_to_ref(tree["encoder"], jcfg)),
                      (jepa_predictor_to_reference(pred, cfg),
                       jax_pred_to_ref(tree["predictor"], jcfg))):
        assert ours.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)
    model = JEPA(cfg)
    model.encoder.load_state_dict(jepa_encoder_from_reference_state_dict(
        jepa_encoder_to_reference(enc, cfg), cfg))
    model.predictor.load_state_dict(jepa_predictor_from_reference_state_dict(
        jepa_predictor_to_reference(pred, cfg), cfg))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def _clips(n_frames, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (3, n_frames, 32, 32, 3), dtype=np.uint8)


def test_videomae_checkpoint_embeds_the_same_in_jax(frame_corpus, tmp_path):
    cfg = tiny_cfg(TrainConfig, "videomae", frame_corpus, tmp_path, "dev_1_g0_default_0_0")
    path = run_videomae(cfg, device="cpu")["checkpoint"]
    raw = torch.load(path, weights_only=True)
    assert {"model_state_dict", "qkv_k_bias", "opt", "epoch", "step", "rng", "meta",
            "train_loss", "val_loss", "batch_size", "world_size", "lr"} <= raw.keys()
    clips = _clips(cfg.model.num_frames)
    ours = make_embed_fn("videomae", path, cfg.model, device="cpu")(clips)
    m = cfg.model
    params = load_reference_checkpoint(path, depth=m.depth, decoder_depth=m.decoder_depth)
    ref = jax_videomae.embed(params, jnp.asarray(clips), JaxModelConfig(**VIDEOMAE_MODEL))
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=1e-4)


def test_jepa_checkpoint_embeds_the_same_in_jax(frame_corpus, tmp_path):
    cfg = tiny_cfg(TrainConfig, "jepa", frame_corpus, tmp_path, "dev_1_g0_default_0_0")
    path = run_jepa(cfg, device="cpu")["checkpoint"]
    raw = torch.load(path, weights_only=True)
    assert {"encoder", "predictor", "target_encoder", "opt", "scaler", "epoch", "step", "rng",
            "meta", "loss", "batch_size", "world_size", "lr"} <= raw.keys()
    assert raw["meta"]["collator_step"] == -1 and raw["meta"]["family"] == "jepa"
    clips = _clips(cfg.model.num_frames)
    ours = make_embed_fn("jepa", path, cfg.model, device="cpu")(clips)
    m = cfg.model
    trees = load_reference_jepa_checkpoint(path, depth=m.depth, pred_depth=m.pred_depth)
    ref = jax_jepa.embed(trees["encoder"], jnp.asarray(clips), JaxModelConfig(**JEPA_MODEL))
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-5, atol=1e-5)
