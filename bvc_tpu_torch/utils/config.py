"""Configuration (counterpart of ``DataConfig``, ``ModelConfig``,
``MaskConfig``, ``OptimConfig`` and ``TrainConfig`` of
``bvc_tpu.utils.config``, and of the ``VIT_DIMS`` table of
``bvc_tpu.models.vit``).

The same field names and defaults as the JAX package, so one set of flags or
one yaml drives both; ``bvc_tpu.utils`` imports JAX, so the port keeps its
own copy.  The model defaults are VideoMAE-B: 224 px, 16 frames, tubelet 2,
patch 16, 768 wide, 12 layers, 12 heads, a 384-wide 4-layer decoder, bf16
activations; the mask defaults are tube masking at 0.9; the optimizer
defaults are SGD with Nesterov momentum 0.9 at lr 0.1.
:meth:`TrainConfig.dump_yaml` writes ``params_{run_id}.yaml`` with the keys
of the JAX package's dump.

Also the run-id codec :class:`RunId`: the reference's
``{curr}_{stage}_{group}_{condition}_{fold}_{seed}`` names the checkpoints
(``model_{run_id}``) and the embedding CSVs, and the evaluation parses
metadata back out of them (``notebooks/EvaluateEmbeddings.ipynb`` cell 9).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

# name: (embed_dim, depth, num_heads) of the JEPA ViTs (reference factories
# vision_transformer.py:551-600)
VIT_DIMS: dict[str, tuple[int, int, int]] = {
    "vit_tiny": (192, 12, 3),
    "vit_small": (384, 12, 6),
    "vit_base": (768, 12, 12),
    "vit_large": (1024, 24, 16),
    "vit_huge": (1280, 32, 16),
    "vit_giant": (1408, 40, 16),
}


def run_id_from_checkpoint(fp: str | Path) -> str:
    """``.../model_{run_id}.pth.tar`` (the port's checkpoints) or
    ``model_{run_id}.ckpt`` (the JAX package's) -> ``run_id``."""
    name = Path(fp).name
    if name.startswith("model_"):
        name = name[len("model_"):]
    for suffix in (".pth.tar", ".ckpt"):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
    return name


@dataclass(frozen=True)
class RunId:
    """Codec for the ``{curr}_{stage}_{group}_{condition}_{fold}_{seed}`` contract.

    Mirrors ``parse_fname`` in the reference notebook (cell 9) and the
    ``run_id=`` assembly in e.g. ``slurmscripts/generative/slurm_dev_def.bash:99``.
    """

    curriculum: str  # 'dev' | 'adev' | 'rnd' | 'adult' | ... (free-form)
    stage: int
    train_group: str  # 'g0' | 'g1' | 'g2' | 'g3' | 'gr' | 'na'
    condition: str  # 'default' | 'shuffle' | 'static' | 'MatchedSpatial' | ...
    fold: int
    seed: int

    def __str__(self) -> str:
        return "_".join([self.curriculum, str(self.stage), self.train_group, self.condition,
                         str(self.fold), str(self.seed)])

    @staticmethod
    def parse(run_id: str) -> "RunId":
        parts = run_id.split("_")
        if len(parts) < 6:
            # Degenerate ids (e.g. untrained baselines named with 'na') parse
            # the way the notebook's parse_fname treats them.
            return RunId("untrained", 0, "na", "na", 0, 0)
        # the first three and last two fields are unambiguous; the
        # condition takes what is between
        curr, stage = parts[0], int(parts[1])
        fold, seed = int(parts[-2]), int(parts[-1])
        return RunId(curr, stage, parts[2], "_".join(parts[3:-2]), fold, seed)

    @staticmethod
    def from_checkpoint_path(fp: str | Path) -> "RunId":
        """Invert the ``model_{run_id}`` checkpoint naming (reference
        ``benchmarks/compute_embeddings_videomae.py:129-131``)."""
        return RunId.parse(run_id_from_checkpoint(fp))

    def train_groups_seen(self) -> str:
        """Cumulative groups after this stage, as the notebook reports them.

        ``get_traingroups`` (notebook cell 9): dev → 'g0g1g2'[:2*stage],
        adev → 'g2g1g0'[:2*stage], otherwise 'na'.
        """
        if self.curriculum == "dev":
            return "g0g1g2"[: 2 * self.stage]
        if self.curriculum == "adev":
            return "g2g1g0"[: 2 * self.stage]
        return "na"


@dataclass
class DataConfig:
    """Input-pipeline knobs (reference CLI flags + homeview constants)."""

    jpg_root: str = ""
    train_group: str = "g0"
    ds_rate: int = 1
    fold: int = 0
    num_folds: int = 3  # 'max_folds' at generative/homeview.py:33
    condition: str = "default"
    n_trainsamples: int = 81000
    num_frames: int = 16
    tubelet_size: int = 2
    image_size: int = 224
    interval: int = 0  # pair sampling gap (predictive/contrastive)
    augs: str = "n"  # subset of 'cjbgo'
    crop_scale: tuple[float, float] = (1.0, 1.0)
    keep_val: bool = False  # keep_val=='y' → val_ratio 0.1, else 0
    batch_size: int = 16  # per-device batch
    shuffle: bool = True
    seed: int = 0
    num_workers: int = 6  # host decode threads
    prefetch: int = 2  # batches in flight
    # ship uint8 frames and normalize on the device (4x less H2D)
    feed_uint8: bool = True
    # Frames per contiguous fold segment: 30 min * 60 s * 30 fps / ds_rate
    # (generative/homeview.py:158).
    segment_minutes: float = 30.0
    native_fps: float = 30.0
    # Matched-complexity control data root ('controls.py:44-49')
    control_data_root: str = ""
    # Packed-corpus root (data/packed.py): plain transforms read
    # pre-resized uint8 memmaps instead of decoding JPEGs per step
    pack_root: str = ""

    @property
    def segment_size(self) -> int:
        return int(self.segment_minutes * 60 * self.native_fps / self.ds_rate)


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
    # the JEPA predictor's heads and MLP ratio; 0 takes the encoder's
    pred_num_heads: int = 0
    pred_mlp_ratio: float = 0.0
    # JEPA token positions: 'sincos3d' adds the fixed 3-D tables to the
    # tokens; 'rope3d' adds none and rotates every attention's queries and
    # keys by their grid position (V-JEPA 2's 3-D RoPE, ops/rope.py)
    pos_embed: str = "sincos3d"
    # Hiera (architecture 'hiera', models/hiera.py), read by nothing else:
    # hidden_size is the first stage's width, the patch embedding a Conv3d
    # of kernel patch_kernel, stride (tubelet_size, patch_size, patch_size)
    # and padding patch_padding; stage i holds stage_depths[i] blocks of
    # stage_heads[i] heads at dim_mul^i times the width; queries pool by
    # q_stride at the first block of stages 2 .. q_pool + 1; masks drop
    # whole units of mask_unit_size tokens, and the stages named in
    # mask_unit_attn attend within a unit (the next stage's first block
    # too). The decoder takes decoder_hidden_size, decoder_depth, decoder_num_heads
    stage_depths: tuple[int, ...] = ()
    stage_heads: tuple[int, ...] = ()
    dim_mul: float = 2.0
    q_pool: int = 2
    q_stride: tuple[int, int, int] = (1, 2, 2)
    mask_unit_size: tuple[int, int, int] = (1, 8, 8)
    mask_unit_attn: tuple[bool, ...] = (True, True, False, False)
    patch_kernel: tuple[int, int, int] = (3, 7, 7)
    patch_padding: tuple[int, int, int] = (1, 3, 3)
    norm_pix_loss: bool = True
    use_mean_pooling: bool = True
    init_std: float = 0.02
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True
    drop_path_rate: float = 0.0
    # compute
    dtype: str = "bfloat16"  # activation/compute dtype
    remat: bool = False  # recompute each block's activations in the backward
    # bf16-stored attention logits for the JEPA target encoder and gradient
    # paths where their attention runs plain ('xla_bf16', see
    # make_jepa_train_step); the flash kernels keep f32 scores
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

    # VideoMAE tube / random masking, Hiera's whole mask units; JEPA:
    # 'multiblock3d' selects V-JEPA's 3-D collator (masks/multiblock3d.py),
    # any other value the 2-D one
    sampler: str = "tube"  # 'tube' | 'random' | 'mask_unit' | 'multiblock3d'
    mask_ratio: float = 0.9
    # JEPA multi-block collator, read by masks.multiblock.mask_collate
    enc_mask_scale: tuple[float, float] = (0.85, 1.0)
    pred_mask_scale: tuple[float, float] = (0.15, 0.2)
    aspect_ratio: tuple[float, float] = (0.75, 1.5)
    num_enc_masks: int = 1
    num_pred_masks: int = 4
    min_keep: int = 10
    allow_overlap: bool = False
    # multiblock3d: blocks of pred_mask_scale (spatial, full duration)
    # whose union is the one prediction mask
    pred_num_blocks: int = 8


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
    # JEPA target-encoder EMA ramp: what the caller passes as
    # make_jepa_train_step's ema and ema_fallback
    ema: tuple[float, float] = (0.996, 1.0)
    ema_fallback: float = 0.998
    # SimCLR: InfoNCE negatives and BatchNorm statistics per data shard
    # ('per_replica') or over the whole batch; one GPU is one shard
    contrastive_negatives: str = "global"
    bn_stats: str = "global"
    # 'none' keeps lr constant; 'warmup_cosine' warms start_lr -> lr over
    # warmup_epochs, then decays lr -> final_lr by a cosine.  The warmup
    # epochs and the horizon's padding ipe_scale become make_optimizer's
    # (warmup, total) steps through training.optim.schedule_steps
    schedule: str = "none"  # 'none' | 'warmup_cosine'
    warmup_epochs: float = 0.0
    start_lr: float = 0.0
    final_lr: float = 0.0
    # cosine weight-decay schedule weight_decay -> final_wd; None: constant
    final_wd: float | None = None
    ipe_scale: float = 1.25
    # >1: average the gradients of that many microbatches before the one
    # optimizer step (the trainers pass it to the steps' grad_accum)
    grad_accum_steps: int = 1


@dataclass
class TrainConfig:
    """One curriculum stage's run: the JAX package's fields, so
    ``params_{run_id}.yaml`` holds the same keys.  ``mesh_shape`` (the
    CLI's ``--mesh``: ``{'data': N}``, ``{'data': N, 'model': M}``,
    ``{'data': N, 'seq': S}`` (with or without ``model``) or ``{'data': N,
    'pipe': P}``, over as many ranks as the sizes multiply to) and
    ``param_sharding`` (``replicated``, ``zero1``, ``fsdp`` or ``tp``) lay
    the run out over the GPUs; ``pipe_microbatches`` acts only on a mesh
    with ``pipe``."""

    run_id: str = ""
    savedir: str = ""
    init_checkpoint_path: str = "na"
    # checkpoint each epoch and pick up from model_{run_id}.pth.tar when
    # resuming
    save_every_epoch: bool = False
    # snapshot the state to the host, then write on a background thread
    async_save: bool = False
    resume: bool = False
    n_epoch: int = 1
    max_epoch_iters: int = 0  # 0 → as many as the data allows
    seed: int = 0
    log_freq: int = 10
    log_grad_stats: bool = False
    # one torch.profiler trace of train steps 1-3 to this dir; "" disables
    profile_dir: str = ""
    script: str = ""
    mesh_shape: dict[str, int] = field(default_factory=dict)
    param_sharding: str = "replicated"
    pipe_microbatches: int = 4
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    mask: MaskConfig = field(default_factory=MaskConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def dump_yaml(self, path: str | Path) -> None:
        """Provenance dump, reference ``pretrain_jepa.py:206-209``
        (``params_{run_id}.yaml``)."""
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)
