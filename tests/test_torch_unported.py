"""``ModelConfig.remat`` in each module that builds blocks, and the JEPA
encoder on a spatial grid other than its configured one.  Both once raised
in the port (test names kept).  Now each module honours remat: its block
stacks checkpoint their activations, as the JAX package's
``run_blocks(..., remat)`` does, and the forward is unchanged.  The encoder
resizes its position table (``interpolate_pos_table_3d``) and matches the
JAX encoder within ``tests/test_torch_jepa.py``'s 1e-5."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvc_tpu.models import jepa as jax_jepa
from bvc_tpu.utils.config import ModelConfig as JaxModelConfig
from bvc_tpu_torch.models.convert import jepa_encoder_from_jax_params
from bvc_tpu_torch.models.jepa import JEPA, JEPAEncoder, JEPAPredictor
from bvc_tpu_torch.models.videomae import VideoMAEEncoder, VideoMAEPretrain
from bvc_tpu_torch.utils.config import ModelConfig

VIDEOMAE = dict(image_size=32, patch_size=8, num_frames=2, tubelet_size=1, hidden_size=64,
                depth=1, num_heads=2, decoder_hidden_size=32, decoder_depth=1,
                decoder_num_heads=2, mlp_ratio=2.0, dtype="float32")
JEPA_CFG = dict(family="jepa", image_size=32, patch_size=8, num_frames=2, tubelet_size=1,
                hidden_size=64, depth=1, num_heads=2, mlp_ratio=2.0, pred_depth=1,
                pred_emb_dim=32, dtype="float32")


def _stacks(module):
    return [m for m in module.modules() if type(m).__name__ == "Blocks"]


@pytest.mark.parametrize("module,cfg", [(VideoMAEEncoder, VIDEOMAE),
                                        (VideoMAEPretrain, VIDEOMAE),
                                        (JEPAEncoder, JEPA_CFG),
                                        (JEPAPredictor, JEPA_CFG),
                                        (JEPA, JEPA_CFG)],
                         ids=["VideoMAEEncoder", "VideoMAEPretrain", "JEPAEncoder",
                              "JEPAPredictor", "JEPA"])
def test_remat_raises(module, cfg):
    plain = module(ModelConfig(**cfg))
    remat = module(ModelConfig(**cfg, remat=True))
    assert _stacks(remat) and all(s.remat for s in _stacks(remat))
    assert not any(s.remat for s in _stacks(plain))
    for (n, a), b in zip(plain.state_dict().items(), remat.state_dict().values()):
        assert torch.equal(a, b), n
    if module in (VideoMAEEncoder, JEPAEncoder):
        video = torch.randint(0, 256, (2, 2, 32, 32, 3), dtype=torch.uint8)
        assert torch.equal(remat(video), plain(video))


def test_resized_position_table_raises():
    """A 48 px clip on the 32 px config: a 6x6 grid read against the 4x4
    table resized bicubically, as JAX's ``encoder_forward`` does."""
    jcfg = JaxModelConfig(**JEPA_CFG)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(np.asarray, jax_jepa.init_params(jax.random.PRNGKey(0), jcfg))
    enc = JEPAEncoder(ModelConfig(**JEPA_CFG))
    enc.load_state_dict(jepa_encoder_from_jax_params(tree["encoder"], enc.cfg))
    video = rng.standard_normal((2, 2, 48, 48, 3)).astype(np.float32)
    ours = enc(torch.from_numpy(video))
    assert ours.shape == (2, 2 * 6 * 6, 64)
    ref = jax_jepa.encoder_forward(tree["encoder"], jnp.asarray(video), jcfg)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="only interpolate spatially"):
        enc(torch.zeros(1, 4, 48, 48, 3))
