"""Exact-erf GELU with a clamped-polynomial path for sub-f32 inputs.

Counterpart of :mod:`bvc_tpu.ops.gelu`, with the same coefficients::

    erf(x / sqrt(2)) ~= x * P(x^2),   P of degree 7
    gelu(x) = 0.5 * x * (1 + x * P(x^2)),   x above 4, 0 below -4

evaluated in f32 whatever the input dtype.  Its error (3.8e-5 inside
|x| <= 4, 1.3e-4 at the clamp) is below bf16 resolution where it occurs, so
``impl='auto'`` takes the polynomial for bf16/f16 inputs and exact erf for
f32, as the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# P(u) with u = x^2: erf(x / sqrt(2)) ~= x * P(x^2) on |x| <= 4.
GELU_ERF_POLY_COEF: tuple[float, ...] = (
    7.9734678899e-01,
    -1.3177568632e-01,
    1.9010796243e-02,
    -2.0129805657e-03,
    1.4971004030e-04,
    -7.3142603991e-06,
    2.0839182688e-07,
    -2.6025839423e-09,
)

_CLAMP = 4.0


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """Clamped-polynomial erf-GELU; f32 internals, input dtype out."""
    xf = x.float()
    u = xf * xf
    p = torch.full_like(u, GELU_ERF_POLY_COEF[-1])
    for c in GELU_ERF_POLY_COEF[-2::-1]:
        p = p * u + c
    g = 0.5 * xf * (1.0 + xf * p)
    g = torch.where(xf > _CLAMP, xf, g)
    g = torch.where(xf < -_CLAMP, 0.0, g)
    return g.to(x.dtype)


def gelu(x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Erf-GELU.  ``impl``: ``'auto'`` (polynomial below f32, exact erf
    otherwise), ``'exact'`` or ``'poly'``."""
    if impl == "auto":
        impl = "poly" if torch.finfo(x.dtype).bits < 32 else "exact"
    if impl == "poly":
        return gelu_poly(x)
    if impl == "exact":
        return F.gelu(x, approximate="none")
    raise ValueError(f"unknown gelu impl {impl!r}")
