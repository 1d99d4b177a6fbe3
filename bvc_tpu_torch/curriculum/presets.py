"""Curriculum and family presets — the 21 slurm scripts as data (a copy of
:mod:`bvc_tpu.curriculum.presets`, every value as it is).

The reference encodes its experiment grid in bash (SURVEY.md §2.8:
``slurmscripts/{generative,generative_long,predictive,contrastive,
complexity_control}/slurm_{dev,adev,rnd,adult,unt}_*.bash``).  Each script
is an SBATCH header + env-var block + 3-stage loop.  Here the same grid is
declarative data consumed by :mod:`bvc_tpu_torch.curriculum.driver`.

``CURRICULA`` maps curriculum name → per-stage train groups
(``slurm_dev_def.bash:100`` and siblings); ``FAMILY_PRESETS`` maps the
trainer family → its env-var block (``generative/slurm_dev_def.bash:43-66``,
``predictive/slurm_dev_def.bash:45-69``,
``contrastive/slurm_dev_def.bash:101-157`` incl. the per-stage lr and
interval schedules).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# stage → train_group (3 stages; 'gr' resamples per stage for rnd;
# adult repeats g3)
CURRICULA: dict[str, list[str]] = {
    "dev": ["g0", "g1", "g2"],
    "adev": ["g2", "g1", "g0"],
    "rnd": ["gr", "gr", "gr"],
    "adult": ["g3", "g3", "g3"],
}


@dataclass
class FamilyPreset:
    family: str
    n_epoch: int
    batch_size: int
    lr: float
    max_epoch_iters: int
    n_trainsamples: int
    num_frames: int
    tubelet_size: int
    optim: str = "sgd"
    momentum: float = 0.9
    wd: float = 0.0
    augs: str = "n"
    interval: int = 0
    mask_sampler: str = "tube"
    mask_ratio: float = 0.9
    enc_mask_scale: float = 0.85
    pred_mask_scale: float = 0.1
    allow_overlap: bool = False
    architecture: str = "base"
    pred_emb_dim: int = 384
    # per-stage overrides: stage idx (0-based) → {field: value}
    stage_overrides: dict[int, dict[str, Any]] = field(default_factory=dict)


FAMILY_PRESETS: dict[str, FamilyPreset] = {
    # generative/slurm_dev_def.bash:43-66
    "generative": FamilyPreset(
        family="videomae", n_epoch=5, batch_size=16, lr=0.1,
        max_epoch_iters=2000, n_trainsamples=128000,
        num_frames=16, tubelet_size=2, mask_ratio=0.9,
    ),
    # generative_long/slurm_dev_def.bash
    "generative_long": FamilyPreset(
        family="videomae", n_epoch=20, batch_size=16, lr=0.1,
        max_epoch_iters=1500, n_trainsamples=100000,
        num_frames=16, tubelet_size=2, mask_ratio=0.9,
    ),
    # predictive/slurm_dev_def.bash:45-69
    "predictive": FamilyPreset(
        family="jepa", n_epoch=2, batch_size=16, lr=0.03,
        max_epoch_iters=5000, n_trainsamples=1280000,
        num_frames=2, tubelet_size=1, augs="cg", interval=300,
        enc_mask_scale=0.85, pred_mask_scale=0.1, allow_overlap=False,
    ),
    # predictive/slurm_unt_def.bash (single-stage per-group baselines)
    "predictive_unt": FamilyPreset(
        family="jepa", n_epoch=2, batch_size=64, lr=0.1,
        max_epoch_iters=5000, n_trainsamples=1280000,
        num_frames=2, tubelet_size=1, augs="cg", interval=300,
    ),
    # contrastive/slurm_dev_def.bash:101-157: lr 1e-2→1e-3→1e-4,
    # interval 900→90→9 per stage
    "contrastive": FamilyPreset(
        family="simclr", n_epoch=1, batch_size=32, lr=0.01,
        max_epoch_iters=1500, n_trainsamples=192000,
        num_frames=2, tubelet_size=1, augs="cjo", interval=900,
        architecture="resnet18", pred_emb_dim=512,
        stage_overrides={
            1: {"lr": 1e-3, "interval": 90},
            2: {"lr": 1e-4, "interval": 9},
        },
    ),
    # complexity_control/slurm_dev_{ms,mst,mt}.bash: Matched* conditions
    # (n_trainsamples=162000; mst/mt use single-frame clips)
    "complexity_control": FamilyPreset(
        family="videomae", n_epoch=5, batch_size=16, lr=0.1,
        max_epoch_iters=2000, n_trainsamples=162000,
        num_frames=16, tubelet_size=2, mask_ratio=0.9,
    ),
}

def apply_overrides(preset: FamilyPreset, spec: str) -> FamilyPreset:
    """Materialise a preset with ``k=v,k=v`` overrides (CLI smoke runs).

    Values are coerced to the field's type; booleans accept
    true/false/y/n/1/0 (``bool("False")`` is True — never use raw bool()).
    """
    import dataclasses

    overrides = {}
    for part in spec.split(","):
        if not part.strip():
            continue
        k, v = (x.strip() for x in part.split("="))
        current = getattr(preset, k)  # AttributeError on unknown keys
        if isinstance(current, bool):
            lv = v.lower()
            if lv in ("1", "true", "y", "yes"):
                overrides[k] = True
            elif lv in ("0", "false", "n", "no"):
                overrides[k] = False
            else:
                raise ValueError(f"bad boolean override {k}={v!r}")
        else:
            overrides[k] = type(current)(v)
    return dataclasses.replace(preset, **overrides)


CONDITION_FRAME_OVERRIDES = {
    # mst/mt variants run single-frame models
    # (complexity_control/slurm_dev_mst.bash)
    "MatchedSpatioTemporal": {"num_frames": 1, "tubelet_size": 1},
    "MatchedTemporal": {"num_frames": 1, "tubelet_size": 1},
}
