"""``ModelConfig.remat`` in each module that builds blocks.  It once raised
in the port (test name kept); now each module honours it: its block stacks
checkpoint their activations, as the JAX package's
``run_blocks(..., remat)`` does, and the forward is unchanged.  What the
port still lacks raises rather than being ignored: a position table resized
to another spatial grid."""

from __future__ import annotations

import pytest
import torch

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
    enc = JEPAEncoder(ModelConfig(**JEPA_CFG))
    with pytest.raises(NotImplementedError, match="interpolate_pos_table_3d"):
        enc(torch.zeros(1, 2, 48, 48, 3))
