"""Model configuration (counterpart of ``bvc_tpu.utils.config.ModelConfig``).

The same field names and defaults as the JAX package, so one set of flags or
one yaml drives both; ``bvc_tpu.utils`` imports JAX, so the port keeps its
own copy.  The defaults are VideoMAE-B: 224 px, 16 frames, tubelet 2,
patch 16, 768 wide, 12 layers, 12 heads, bf16 activations.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ModelConfig:
    """Architecture knobs shared across the three model families."""

    family: str = "videomae"  # 'videomae' | 'jepa' | 'simclr'
    architecture: str = "base"  # vit size key or resnet name
    image_size: int = 224
    patch_size: int = 16
    num_frames: int = 16
    tubelet_size: int = 2
    in_channels: int = 3
    # encoder
    hidden_size: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    # decoder (VideoMAE) / predictor (JEPA)
    decoder_hidden_size: int = 384
    decoder_depth: int = 4
    decoder_num_heads: int = 6
    pred_depth: int = 6
    pred_emb_dim: int = 384
    norm_pix_loss: bool = True
    use_mean_pooling: bool = True
    init_std: float = 0.02
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True
    drop_path_rate: float = 0.0
    # compute
    dtype: str = "bfloat16"  # activation/compute dtype
    remat: bool = False  # activation checkpointing of each block
    # bf16-stored attention logits for the JEPA target encoder and gradient
    # paths (JEPA slice); kept so the two packages share one field set
    target_score_bf16: bool = True
    autocast_scores: bool = True

    @property
    def tokens_per_frame(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_time_steps(self) -> int:
        return self.num_frames // self.tubelet_size

    @property
    def seq_len(self) -> int:
        return self.num_time_steps * self.tokens_per_frame
