"""The slice as a whole: W8A8 VideoMAE and JEPA embeddings of the port
against the JAX package's W8A8 embeddings (``videomae.embed`` /
``jepa.embed`` on ``quantize_encoder_tree(params)``), at the tiny
configurations of ``tests/test_quant.py``, in f32 and bf16.

The port reaches the same int8 weights two ways: it quantizes the converted
f32 weights itself, or it loads JAX's quantized tree; the two give the same
embeddings.  Tolerances: per-row cosine >= 0.99999 to JAX (the quantized
products agree exactly, so only the unquantized steps' roundings differ;
the readings are in the asserts), and >= 0.995 to the port's own
unquantized embedding, the JAX test's bound for the quantization noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.models import jepa as jax_jepa
from bvc_tpu.models import videomae as jax_videomae
from bvc_tpu.ops.quant import quantize_encoder_tree
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu_torch.evalbench import extract
from bvc_tpu_torch.models.convert import jepa_encoder_from_jax_params, videomae_from_jax_params
from bvc_tpu_torch.models.jepa import JEPAEncoder
from bvc_tpu_torch.models.videomae import VideoMAEEncoder
from bvc_tpu_torch.ops.quant import QuantLinear, quantize_encoder
from bvc_tpu_torch.utils.config import ModelConfig

# tests/test_quant.py:113-118 and :129-132
VIDEOMAE = dict(image_size=32, patch_size=8, num_frames=4, tubelet_size=2, hidden_size=32,
                depth=2, num_heads=4, decoder_hidden_size=16, decoder_depth=1,
                decoder_num_heads=2)
JEPA = dict(family="jepa", image_size=16, patch_size=8, num_frames=2, tubelet_size=1,
            hidden_size=32, depth=2, num_heads=4)
FAMILIES = {
    # JAX init, port encoder, converter, JAX embed, block key, config
    "videomae": (jax_videomae.init_params, VideoMAEEncoder, videomae_from_jax_params,
                 jax_videomae.embed, "encoder", VIDEOMAE),
    "jepa": (jax_jepa.init_encoder_params, JEPAEncoder, jepa_encoder_from_jax_params,
             jax_jepa.embed, "blocks", JEPA),
}
COSINE_TO_JAX = 0.99999
COSINE_TO_UNQUANTIZED = 0.995


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cos(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _setup(family: str, dtype: str):
    init, encoder, convert, embed, key, kw = FAMILIES[family]
    jcfg = JaxModelConfig(**kw, dtype=dtype)
    cfg = ModelConfig(**kw, dtype=dtype)
    rng = np.random.default_rng(0)
    # every leaf perturbed: non-trivial biases and LayerNorm affines
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32),
        init(jax.random.PRNGKey(0), jcfg))
    qtree = jax.tree_util.tree_map(np.asarray, quantize_encoder_tree(tree, (key,)))
    clips = rng.integers(0, 256, (3, cfg.num_frames, cfg.image_size, cfg.image_size, 3),
                         dtype=np.uint8)
    run = jax.jit(lambda p, v: embed(p, v, jcfg))
    ref = np.asarray(run(jax.tree_util.tree_map(jnp.asarray, qtree), jnp.asarray(clips)))
    return cfg, encoder, convert, tree, qtree, clips, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["videomae", "jepa"])
def test_w8a8_embed_matches_jax(family, dtype):
    cfg, encoder, convert, tree, qtree, clips, ref = _setup(family, dtype)
    plain = encoder(cfg)
    plain.load_state_dict(convert(tree, cfg))
    loaded = quantize_encoder(encoder(cfg))
    loaded.load_state_dict(convert(qtree, cfg))
    assert isinstance(loaded.blocks.layers[0].qkv, QuantLinear)
    video = torch.from_numpy(clips)
    with torch.no_grad():
        unquantized = plain.embed(video).numpy()
        ours = quantize_encoder(plain).embed(video).numpy()
        ours_loaded = loaded.embed(video).numpy()
    np.testing.assert_array_equal(ours_loaded, ours)  # the same int8 weights
    cos = _cos(ours, ref)
    err = np.abs(ours - ref).max()
    # read: f32 cosine 1.000000 (max abs err 6.0e-7 VideoMAE, 1.8e-7 JEPA);
    # bf16 0.999999 (3.5e-3) and 0.999996 (6.7e-3)
    assert cos.min() >= COSINE_TO_JAX, (cos.min(), err)
    assert _cos(ours, unquantized).min() >= COSINE_TO_UNQUANTIZED


def test_untrained_embed_fn_int8_end_to_end():
    cfg = ModelConfig(**VIDEOMAE, dtype="float32")
    clips = np.random.default_rng(2).integers(0, 256, (2, 4, 32, 32, 3), dtype=np.uint8)
    fn = extract.untrained_embed_fn("videomae", cfg, seed=0, device="cpu", quantize="int8")
    assert all(isinstance(layer.qkv, QuantLinear) and isinstance(layer.fc1, QuantLinear)
               for layer in fn.model.blocks.layers)
    out = fn(clips)
    ref = extract.untrained_embed_fn("videomae", cfg, seed=0, device="cpu")(clips)
    assert out.shape == ref.shape == (2, cfg.hidden_size) and np.isfinite(out).all()
    assert _cos(out, ref).min() >= COSINE_TO_UNQUANTIZED


@pytest.mark.parametrize("family", ["videomae", "jepa"])
def test_untrained_int8_without_device_needs_cuda(family, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = FAMILIES[family][-1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract.untrained_embed_fn(family, ModelConfig(**kw), quantize="int8")
