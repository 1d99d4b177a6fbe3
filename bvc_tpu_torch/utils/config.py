"""Configuration (counterpart of ``ModelConfig``, ``MaskConfig`` and
``OptimConfig`` of ``bvc_tpu.utils.config``).

The same field names and defaults as the JAX package, so one set of flags or
one yaml drives both; ``bvc_tpu.utils`` imports JAX, so the port keeps its
own copy.  The model defaults are VideoMAE-B: 224 px, 16 frames, tubelet 2,
patch 16, 768 wide, 12 layers, 12 heads, a 384-wide 4-layer decoder, bf16
activations; the mask defaults are tube masking at 0.9; the optimizer
defaults are SGD with Nesterov momentum 0.9 at lr 0.1.
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


@dataclass
class MaskConfig:
    """Masking knobs for both mask families."""

    # VideoMAE tube / random masking
    sampler: str = "tube"  # 'tube' | 'random'
    mask_ratio: float = 0.9
    # JEPA multi-block collator: read by no port code yet, kept for the
    # JEPA slice
    enc_mask_scale: tuple[float, float] = (0.85, 1.0)
    pred_mask_scale: tuple[float, float] = (0.15, 0.2)
    aspect_ratio: tuple[float, float] = (0.75, 1.5)
    num_enc_masks: int = 1
    num_pred_masks: int = 4
    min_keep: int = 10
    allow_overlap: bool = False


@dataclass
class OptimConfig:
    """Optimizer knobs (see :mod:`bvc_tpu_torch.training.optim`)."""

    name: str = "sgd"  # 'sgd' | 'adamw' | 'adam'
    lr: float = 0.1
    weight_decay: float = 0.0
    momentum: float = 0.9
    nesterov: bool = True
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    # weight decay only on tensors with ndim >= 2 (JEPA's biases and norms
    # go without)
    exclude_bias_and_norm_from_wd: bool = False
    # JEPA target-encoder EMA ramp and SimCLR options: read by no port code
    # yet, kept for the JEPA and SimCLR slices
    ema: tuple[float, float] = (0.996, 1.0)
    ema_fallback: float = 0.998
    contrastive_negatives: str = "global"
    bn_stats: str = "global"
    # 'none' keeps lr constant; 'warmup_cosine' warms start_lr -> lr over
    # warmup_epochs, then decays lr -> final_lr by a cosine
    schedule: str = "none"  # 'none' | 'warmup_cosine'
    start_lr: float = 0.0
    final_lr: float = 0.0
    # cosine weight-decay schedule weight_decay -> final_wd; None: constant
    final_wd: float | None = None
    # Read by the trainer (slice 3), not yet by the port: it turns
    # warmup_epochs and ipe_scale into make_optimizer's (warmup, total)
    # steps, and passes grad_accum_steps to make_videomae_train_step's
    # grad_accum (>1: average the gradients of that many microbatches
    # before the one optimizer step).  Until then the caller passes both.
    warmup_epochs: float = 0.0
    ipe_scale: float = 1.25
    grad_accum_steps: int = 1
