"""A copy of the benchmark's tree under a temporary root with tiny cells
added by files and entries alone: the CPU tests' configurations.

``tiny_root(tmp)`` copies ``BENCHMARK.json`` and ``portbench/`` (its data
files and readers), then adds the configurations ``tiny_videomae`` and
``tiny_jepa`` and the cells ``tiny.train``, ``tiny.train.ddp4`` (four
processes), ``tiny_jepa.train`` and ``tiny.embed``, listed in the per-layer metrics that apply to their kind.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_VIDEOMAE = {
    "name": "tiny_videomae", "family": "videomae", "reference": "videomae",
    "source": "https://huggingface.co/MCG-NJU/videomae-base",
    "model": {"family": "videomae", "architecture": "base", "image_size": 32, "patch_size": 16,
              "num_frames": 4, "tubelet_size": 2, "in_channels": 3, "hidden_size": 32,
              "depth": 2, "num_heads": 2, "mlp_ratio": 4.0, "decoder_hidden_size": 16,
              "decoder_depth": 1, "decoder_num_heads": 2, "norm_pix_loss": True,
              "layer_norm_eps": 1e-12, "qkv_bias": True, "drop_path_rate": 0.0,
              "dtype": "float32", "remat": False},
    "mask": {"sampler": "tube", "mask_ratio": 0.75},
    "optim": {"name": "sgd", "lr": 0.1, "momentum": 0.9, "nesterov": True, "weight_decay": 0.0},
    "reduced": ["image_size", "num_frames", "depth", "decoder_depth"],
    "assumed": {"note": "a CPU test size"}}

TINY_JEPA = {
    "name": "tiny_jepa", "family": "jepa", "reference": "jepa",
    "source": "https://arxiv.org/abs/2404.08471",
    "model": {"family": "jepa", "architecture": "vit_tiny", "image_size": 64, "patch_size": 16,
              "num_frames": 2, "tubelet_size": 1, "in_channels": 3, "hidden_size": 32,
              "depth": 1, "num_heads": 2, "mlp_ratio": 4.0, "pred_depth": 1,
              "pred_emb_dim": 16, "layer_norm_eps": 1e-6, "qkv_bias": True,
              "drop_path_rate": 0.0, "dtype": "float32", "remat": False},
    "mask": {"enc_mask_scale": [0.85, 1.0], "pred_mask_scale": [0.15, 0.2],
             "aspect_ratio": [0.75, 1.5], "num_enc_masks": 1, "num_pred_masks": 2,
             "min_keep": 2, "allow_overlap": False},
    "optim": {"name": "sgd", "lr": 0.03, "momentum": 0.9, "nesterov": True,
              "weight_decay": 0.0, "exclude_bias_and_norm_from_wd": True,
              "ema": [0.996, 1.0], "ema_fallback": 0.998},
    "reduced": ["image_size", "depth", "pred_depth"],
    "assumed": {"note": "a CPU test size"}}

TRAIN_COMMON = {"checked_steps": 3, "warmup_steps": 4, "calibration_steps": 2,
                "trace_steps": 3, "reference_rows": 2, "n_epoch": 50, "num_workers": 2,
                "batch_per_chip": 4, "rate_metric": "train_clips_per_s", "driver": "train"}

TINY_TRAIN = {**TRAIN_COMMON, "n_trainsamples": 60, "data": {"prefetch": 2},
              "program": {"cli": "bvc_tpu_torch.cli.pretrain_videomae",
                          "trainer": "bvc_tpu_torch.training.trainer_videomae",
                          "step_factory": "make_videomae_train_step",
                          "model_class": "VideoMAEPretrain"},
              "corpus": {"group": "g0", "subjects": ["008MS", "009SS"],
                         "frames_per_subject": 40, "image_size": 32},
              "limits": {"loss_gap": 1e-4, "grad1_gap": 1e-3, "delta3_gap": 1e-3}}

TINY_JEPA_TRAIN = {**TRAIN_COMMON, "n_trainsamples": 60, "data": {"prefetch": 2, "interval": 5},
                   "program": {"cli": "bvc_tpu_torch.cli.pretrain_jepa",
                               "trainer": "bvc_tpu_torch.training.trainer_jepa",
                               "step_factory": "make_jepa_train_step", "model_class": "JEPA"},
                   "corpus": {"group": "g0", "subjects": ["008MS", "009SS"],
                              "frames_per_subject": 40, "image_size": 64},
                   "limits": {"loss_gap": 1e-4, "grad1_gap": 1e-3, "delta3_gap": 1e-3,
                              "target3_gap": 1e-3}}

TINY_EMBED = {"driver": "embed", "rate_metric": "embed_clips_per_s",
              "program": {"extract": "bvc_tpu_torch.evalbench.extract",
                          "config": "bvc_tpu_torch.utils.config"},
              "batch": 2, "pool": 2, "warmup_calls": 1, "calibration_calls": 1,
              "trace_steps": 2, "reference_rows": 2, "limits": {"embed_cos_gap": 1e-8}}

TINY_DDP = {**TINY_TRAIN, "mesh": "data=4", "n_trainsamples": 190,
            "corpus": {**TINY_TRAIN["corpus"], "frames_per_subject": 100}}

CELLS = {"tiny.train": ("tiny_videomae", TINY_TRAIN, "train"),
         "tiny.train.ddp4": ("tiny_videomae", TINY_DDP, "train"),
         "tiny_jepa.train": ("tiny_jepa", TINY_JEPA_TRAIN, "train"),
         "tiny.embed": ("tiny_videomae", TINY_EMBED, "embed")}


def tiny_root(tmp: Path) -> Path:
    """A root with the repository's benchmark and the tiny cells added."""
    root = Path(tmp) / "root"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "tests"))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    for cfg in (TINY_VIDEOMAE, TINY_JEPA):
        (root / "portbench" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        manifest["configs"].append({"name": cfg["name"], "source": cfg["source"],
                                    "file": f"portbench/configs/{cfg['name']}.json",
                                    "reduced": cfg["reduced"], "why": "CPU test size"})
    for cell, (cfg, traffic, kind) in CELLS.items():
        (root / "portbench" / "workloads" / f"{cell}.json").write_text(json.dumps(traffic))
        manifest["workloads"].append({"name": cell, "config": cfg, "traffic": cell,
                                      "chips": 4 if "mesh" in traffic else 1,
                                      "why": "CPU test size"})
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if "workloads" in m and any(w.endswith("." + kind) or f".{kind}." in w
                                        for w in m["workloads"] if not w.startswith("tiny")):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return root
