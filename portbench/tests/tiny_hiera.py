"""The tiny Hiera cell of the CPU tests, added by files and entries to a
copy of the benchmark's tree (:func:`portbench.tests.tiny.tiny_root`): the
configuration ``tiny_hiera`` (4 frames of 64 x 64, patch stride (2, 4, 4),
mask units of 1 x 8 x 8 tokens, so 2 x 2 units a frame pair and 8 a clip,
half of them kept; four stages of depth (1, 2, 2, 1) from width 32 with
heads of 16, queries pooled twice, a decoder 32 wide with heads of 16, f32)
and the cell ``tiny_hiera.train``, listed where ``hiera_h.train.b48`` is.

Its limits sit between the f32 port's readings against the reference (at
most about 1e-6) and those of a port in bf16 and of the cell's faults."""

from __future__ import annotations

import json
from pathlib import Path

from portbench.tests.tiny import TRAIN_COMMON, tiny_root

TINY_HIERA = {
    "name": "tiny_hiera", "family": "videomae", "reference": "hiera",
    "source": "https://arxiv.org/abs/2306.00989",
    "model": {"family": "videomae", "architecture": "hiera", "image_size": 64, "patch_size": 4,
              "num_frames": 4, "tubelet_size": 2, "in_channels": 3, "hidden_size": 32,
              "depth": 6, "stage_depths": [1, 2, 2, 1], "stage_heads": [2, 4, 8, 16],
              "dim_mul": 2.0, "q_pool": 2, "q_stride": [1, 2, 2], "mask_unit_size": [1, 8, 8],
              "mask_unit_attn": [True, True, False, False], "patch_kernel": [3, 7, 7],
              "patch_padding": [1, 3, 3], "mlp_ratio": 4.0,
              "decoder_hidden_size": 32, "decoder_depth": 1, "decoder_num_heads": 2,
              "norm_pix_loss": True, "layer_norm_eps": 1e-6, "qkv_bias": True,
              "drop_path_rate": 0.0, "dtype": "float32", "remat": False},
    "mask": {"sampler": "mask_unit", "mask_ratio": 0.5},
    "optim": {"name": "sgd", "lr": 0.1, "momentum": 0.9, "nesterov": True, "weight_decay": 0.0},
    "reduced": ["image_size", "num_frames", "hidden_size", "stage_depths", "decoder_depth"],
    "assumed": {"note": "a CPU test size"}}

TINY_HIERA_TRAIN = {**TRAIN_COMMON, "n_trainsamples": 60, "data": {"prefetch": 2},
                    "program": {"cli": "bvc_tpu_torch.cli.pretrain_videomae",
                                "trainer": "bvc_tpu_torch.training.trainer_videomae",
                                "step_factory": "make_videomae_train_step",
                                "model_class": "HieraMAE"},
                    "corpus": {"group": "g0", "subjects": ["008MS", "009SS"],
                               "frames_per_subject": 40, "image_size": 64},
                    "limits": {"loss_gap": 1e-5, "grad1_gap": 1e-4, "delta3_gap": 1e-4}}

CELL = "tiny_hiera.train"


def hiera_root(tmp: Path) -> Path:
    """The tiny cells' root with the tiny Hiera cell added."""
    root = tiny_root(tmp)
    cfg = TINY_HIERA
    (root / "portbench" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (root / "portbench" / "workloads" / f"{CELL}.json").write_text(json.dumps(TINY_HIERA_TRAIN))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": cfg["name"], "source": cfg["source"],
                                "file": f"portbench/configs/{cfg['name']}.json",
                                "reduced": cfg["reduced"], "why": "CPU test size"})
    manifest["workloads"].append({"name": CELL, "config": cfg["name"], "traffic": CELL,
                                  "chips": 1, "why": "CPU test size"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "hiera_h.train.b48" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return root
