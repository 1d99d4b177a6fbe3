"""The weights both sides start from, made from the seed on the device.

One ``torch.randn`` call of a ``torch.Generator`` seeded with the run's
seed fills every tensor of a model, in the sorted order of its names:
LayerNorm scales ``1 + 0.1 z``, every other tensor ``0.02 z`` (the
published initialisations' scale, with biases and norms moved off their
zeros and ones so that each leaf has a gradient of its own size).  The
benchmark loads them into the program's model and hands the same tensors to
the reference.
"""

from __future__ import annotations

import math

import torch

NORM_PARTS = ("ln1", "ln2", "norm", "decoder_norm")


def is_norm_scale(name: str) -> bool:
    parts = name.split(".")
    return parts[-1] == "weight" and len(parts) > 1 and parts[-2] in NORM_PARTS


def make_weights(shapes: dict[str, tuple[int, ...]], seed: int, device) -> dict:
    """``{name: f32 tensor}`` on ``device`` for ``shapes``."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for name, size in zip(names, sizes):
        x = z[at:at + size].reshape(shapes[name])
        out[name] = 1.0 + 0.1 * x if is_norm_scale(name) else 0.02 * x
        at += size
    return out


def shapes_of(module: torch.nn.Module) -> dict[str, tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
