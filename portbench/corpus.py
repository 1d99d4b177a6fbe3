"""The training traffic's input: a synthetic head-camera corpus made from
the seed, in the HOMEview layout the trainers read.

- ``jpg/<subject>/frame_<i>.jpg``: empty placeholders, one per frame (the
  trainers list the names; nothing decodes them);
- ``pack/<subject>/frames_<S>.u8`` and ``.json``: the packed shard of the
  port's on-disk format (``[n, S, S, 3]`` uint8 rows in name order, and
  the index ``{"image_size", "dct_scale", "names"}``).

One shard of ``frames_per_subject`` seeded uniform frames is written once
and linked under every subject of the traffic's list, so a corpus of many
subjects writes one subject's bytes: the frame list's ``j``-th frame is the
shard's row ``j % frames_per_subject``.  The frames are drawn on the
device from a ``torch.Generator`` seeded with the run's seed.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch


def write_corpus(root: Path, spec: dict, seed: int, device) -> dict:
    """Write the corpus of ``spec`` (a traffic file's ``corpus``) under
    ``root``; returns ``{"jpg", "pack", "frames", "total"}``."""
    S, F = spec["image_size"], spec["frames_per_subject"]
    gen = torch.Generator(device=device).manual_seed(seed)
    frames = torch.randint(0, 256, (F, S, S, 3), dtype=torch.uint8, generator=gen,
                           device=device).cpu().numpy()
    jpg, pack = root / "jpg", root / "pack"
    shared = pack / "_shard" / f"frames_{S}.u8"
    shared.parent.mkdir(parents=True)
    frames.tofile(shared)
    names = [f"frame_{i:06d}.jpg" for i in range(F)]
    index = json.dumps({"image_size": S, "dct_scale": True, "names": names})
    for subject in spec["subjects"]:
        (jpg / subject).mkdir(parents=True)
        for name in names:
            (jpg / subject / name).touch()
        (pack / subject).mkdir()
        os.symlink(os.path.relpath(shared, pack / subject), pack / subject / f"frames_{S}.u8")
        (pack / subject / f"frames_{S}.json").write_text(index)
    return {"jpg": str(jpg), "pack": str(pack), "frames": frames,
            "total": F * len(spec["subjects"])}


def read_frames(corpus: dict, spec: dict) -> np.ndarray:
    """The shared shard's frames, read back from disk."""
    S, F = spec["image_size"], spec["frames_per_subject"]
    path = Path(corpus["pack"]) / "_shard" / f"frames_{S}.u8"
    return np.fromfile(path, dtype=np.uint8).reshape(F, S, S, 3)
