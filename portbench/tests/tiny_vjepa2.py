"""The tiny V-JEPA 2 cell of the CPU tests, added by files and entries to a
copy of the benchmark's tree (:func:`portbench.tests.tiny.tiny_root`): the
configuration ``tiny_vjepa2`` (2048 tokens cut to a 4 x 4 x 4 grid, one
layer 384 wide with heads of width 64, a predictor 96 wide with heads of
width 32, rotary positions, the 3-D collator) and the cell
``tiny_vjepa2.train``, listed where ``vjepa2_g.train.b16`` is.

Its ``target3_gap`` limit sits between the f32 port's readings against the
reference (at most 7e-7, seeds 2^31 + 7 and 2^32 + 3) and the reading with
the context rotated at ``0 .. Ke - 1`` (2.7e-4); the leaf numbers of the
step read up to 4e-5 on a sound run and 1e-4 with that fault, too near to
part them, so their limits only catch the coarser faults: at the
benchmark's random weights attention is nearly uniform, and a position
fault moves the step's gradient norms little."""

from __future__ import annotations

import json
from pathlib import Path

from portbench.tests.tiny import TRAIN_COMMON, tiny_root

TINY_VJEPA2 = {
    "name": "tiny_vjepa2", "family": "jepa", "reference": "vjepa2",
    "source": "https://arxiv.org/abs/2506.09985",
    "model": {"family": "jepa", "architecture": "vit_tiny", "image_size": 64, "patch_size": 16,
              "num_frames": 8, "tubelet_size": 2, "in_channels": 3, "hidden_size": 384,
              "depth": 1, "num_heads": 6, "mlp_ratio": 4.0, "pred_depth": 1,
              "pred_emb_dim": 96, "pred_num_heads": 3, "pred_mlp_ratio": 4.0,
              "pos_embed": "rope3d", "layer_norm_eps": 1e-6, "qkv_bias": True,
              "drop_path_rate": 0.0, "dtype": "float32", "remat": False,
              "target_score_bf16": False, "autocast_scores": False},
    "mask": {"sampler": "multiblock3d", "pred_mask_scale": [0.3, 0.3],
             "aspect_ratio": [0.75, 1.5], "num_enc_masks": 1, "num_pred_masks": 1,
             "pred_num_blocks": 2},
    "optim": {"name": "sgd", "lr": 0.03, "momentum": 0.9, "nesterov": True,
              "weight_decay": 0.0, "exclude_bias_and_norm_from_wd": True,
              "ema": [0.996, 1.0], "ema_fallback": 0.998},
    "reduced": ["image_size", "num_frames", "hidden_size", "depth", "pred_depth"],
    "assumed": {"note": "a CPU test size"}}

TINY_VJEPA2_TRAIN = {**TRAIN_COMMON, "n_trainsamples": 60, "data": {"prefetch": 2},
                     "program": {"cli": "bvc_tpu_torch.cli.pretrain_jepa",
                                 "trainer": "bvc_tpu_torch.training.trainer_jepa",
                                 "step_factory": "make_jepa_train_step",
                                 "model_class": "JEPA"},
                     "corpus": {"group": "g0", "subjects": ["008MS", "009SS"],
                                "frames_per_subject": 40, "image_size": 64},
                     "limits": {"loss_gap": 1e-4, "grad1_gap": 1e-3, "delta3_gap": 1e-3,
                                "target3_gap": 2e-5}}

CELL = "tiny_vjepa2.train"


def vjepa2_root(tmp: Path) -> Path:
    """The tiny cells' root with the tiny V-JEPA 2 cell added."""
    root = tiny_root(tmp)
    cfg = TINY_VJEPA2
    (root / "portbench" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (root / "portbench" / "workloads" / f"{CELL}.json").write_text(
        json.dumps(TINY_VJEPA2_TRAIN))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": cfg["name"], "source": cfg["source"],
                                "file": f"portbench/configs/{cfg['name']}.json",
                                "reduced": cfg["reduced"], "why": "CPU test size"})
    manifest["workloads"].append({"name": CELL, "config": cfg["name"], "traffic": CELL,
                                  "chips": 1, "why": "CPU test size"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "vjepa2_g.train.b16" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return root
