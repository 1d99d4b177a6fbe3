"""Options of the port's models that come with a later slice raise rather
than being ignored: ``ModelConfig.remat`` (per-block activation
checkpointing, which the JAX package honours in ``run_blocks``) in each
module that builds blocks."""

from __future__ import annotations

import pytest

from bvc_tpu_torch.models.jepa import JEPA, JEPAEncoder, JEPAPredictor
from bvc_tpu_torch.models.videomae import VideoMAEEncoder, VideoMAEPretrain
from bvc_tpu_torch.utils.config import ModelConfig

VIDEOMAE = dict(image_size=32, patch_size=8, num_frames=2, tubelet_size=1, hidden_size=64,
                depth=1, num_heads=2, decoder_hidden_size=32, decoder_depth=1,
                decoder_num_heads=2, mlp_ratio=2.0, dtype="float32")
JEPA_CFG = dict(family="jepa", image_size=32, patch_size=8, num_frames=2, tubelet_size=1,
                hidden_size=64, depth=1, num_heads=2, mlp_ratio=2.0, pred_depth=1,
                pred_emb_dim=32, dtype="float32")


@pytest.mark.parametrize("module,cfg", [(VideoMAEEncoder, VIDEOMAE),
                                        (VideoMAEPretrain, VIDEOMAE),
                                        (JEPAEncoder, JEPA_CFG),
                                        (JEPAPredictor, JEPA_CFG),
                                        (JEPA, JEPA_CFG)],
                         ids=["VideoMAEEncoder", "VideoMAEPretrain", "JEPAEncoder",
                              "JEPAPredictor", "JEPA"])
def test_remat_raises(module, cfg):
    module(ModelConfig(**cfg))  # builds without remat
    with pytest.raises(NotImplementedError, match="remat=True"):
        module(ModelConfig(**cfg, remat=True))
