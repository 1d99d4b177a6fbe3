"""Weight initialisation (counterpart of :mod:`bvc_tpu.models.initializers`).

Linear weights ~ normal truncated at +-2 sigma, times ``std`` (0.02 by
default), and so is VideoMAE's mask token (:func:`trunc_normal_`); biases
zero; LayerNorm scale 1 and bias 0 (``vit.LayerNorm``).  Draws come from a
``torch.Generator``, so the port's random weights differ from the JAX
package's for the same seed: tests that compare the two carry the JAX
weights across (:mod:`bvc_tpu_torch.models.convert`).
"""

from __future__ import annotations

import torch
from torch import nn


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator
                  ) -> torch.Tensor:
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return t.mul_(std)


def init_linear(layer: nn.Linear, std: float, generator: torch.Generator) -> None:
    trunc_normal_(layer.weight, std, generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)
