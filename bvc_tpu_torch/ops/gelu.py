"""Exact-erf GELU with a clamped-polynomial path for sub-f32 inputs.

Counterpart of :mod:`bvc_tpu.ops.gelu`, with the same coefficients::

    erf(x / sqrt(2)) ~= x * P(x^2),   P of degree 7
    gelu(x) = 0.5 * x * (1 + x * P(x^2)),   x above 4, 0 below -4

evaluated in f32 whatever the input dtype.  Its error (3.8e-5 inside
|x| <= 4, 1.3e-4 at the clamp) is below bf16 resolution where it occurs, so
``impl='auto'`` takes the polynomial for bf16/f16 inputs and exact erf for
f32, as the JAX package does.

On bf16 tensors the polynomial runs as the custom operator
``torch.ops.bvc_tpu_torch.gelu_poly(x)`` (:data:`gelu_poly_op`), whose
gradient is ``.gelu_poly_bwd(x, dy)`` (:data:`gelu_poly_bwd_op`; only x is
saved for it, in bf16).  On CUDA tensors they launch the two kernels of
``csrc/gelu.cu``, one pass over memory each, which XLA's fusion gave the
JAX package on the TPU; :func:`gelu_poly_cuda` counts their launches in
``.launches`` (forward) and ``.launches_bwd``.  On CPU tensors they run the
plain versions: :func:`gelu_poly`, the eager chain, and
:func:`gelu_poly_bwd_ref`, its reverse mode written out in the order
PyTorch's autograd takes it through the chain, bit for bit the gradient
autograd gives.  The kernels make the same operations in the same order,
each rounded on its own, so on the card the forward is bit for bit the
eager chain's.  Other dtypes (f16, or f32 with ``impl='poly'``) take the
eager chain.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from bvc_tpu_torch.ops._build import launch, load_library
from bvc_tpu_torch.utils.profiling import profiler_range

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


def gelu_poly_bwd_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``dx`` of :func:`gelu_poly` at ``x`` for the output gradient ``dy``,
    in f32, in ``x``'s dtype: dy * (0.5 + x P(u) + x^3 P'(u)) on |x| <= 4, dy
    above 4, 0 below -4, as the reverse mode of the chain, with the
    operations and the order of PyTorch's autograd through it (the
    clamps' masks, the product rule at (0.5 x) (1 + x p), each Horner step's
    gradient, u's summed from the last step to the first, then x's from the
    clamp, x p, 0.5 x and twice from u = x x).  Where P(u) overflows (|x|
    above about 2000, or infinite) it gives NaN, as autograd does."""
    xf = x.float()
    u = xf * xf
    q = [torch.full_like(u, GELU_ERF_POLY_COEF[-1])]
    for c in GELU_ERF_POLY_COEF[-2::-1]:
        q.append(q[-1] * u + c)
    p = q[-1]
    gg = torch.where(xf < -_CLAMP, 0.0, dy.float())
    dx = torch.where(xf > _CLAMP, gg, 0.0)
    gg = torch.where(xf > _CLAMP, 0.0, gg)
    ga, gb = gg * (1.0 + xf * p), gg * (0.5 * xf)
    dx = dx + gb * p
    gp = gb * xf
    dx = dx + ga * 0.5
    gu = gp * q[-2]
    for qi in q[-3::-1]:
        gp = gp * u
        gu = gu + gp * qi
    gx = gu * xf
    return (dx + gx + gx).to(x.dtype)


# the library in csrc/ that each custom operator's CUDA side launches
OP_LIBRARIES = {"gelu_poly": "gelu", "gelu_poly_bwd": "gelu"}
_SIGNATURES = {"bvc_gelu_poly_fwd": (2, 1), "bvc_gelu_poly_bwd": (3, 1)}


@functools.cache
def _library() -> ctypes.CDLL:
    """``csrc/gelu.cu``, built if needed, with its entry points typed."""
    return load_library("gelu", _SIGNATURES)


def _check_kernel_inputs(caller: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a CUDA bf16 tensor, all of one shape on
    one device."""
    first = next(iter(tensors.values()))
    for name, x in tensors.items():
        if not x.is_cuda or x.dtype != torch.bfloat16:
            raise ValueError(f"{caller}: {name} must be a CUDA bf16 tensor, got {x.dtype} "
                             f"on {x.device}")
        if x.shape != first.shape or x.device != first.device:
            raise ValueError(f"{caller}: {', '.join(tensors)} differ in shape or device")


def gelu_poly_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/gelu.cu``'s forward on a CUDA bf16 tensor on the
    current stream; returns :func:`gelu_poly` of it, contiguous, bit for bit.
    Raises on any other input and if the launch fails; launches nothing for
    an empty tensor.  Counts launches in ``.launches``."""
    _check_kernel_inputs("gelu_poly_cuda", x=x)
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    launch("gelu_poly_cuda", x.device, _library().bvc_gelu_poly_fwd, x.data_ptr(),
           y.data_ptr(), x.numel())
    gelu_poly_cuda.launches += 1
    return y


def gelu_poly_bwd_cuda(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/gelu.cu``'s backward on CUDA bf16 ``x`` and ``dy`` of
    one shape on the current stream; returns :func:`gelu_poly_bwd_ref` of
    them, contiguous.  Raises on any other input and if the launch fails;
    launches nothing for an empty tensor.  Counts launches in
    ``gelu_poly_cuda.launches_bwd``."""
    _check_kernel_inputs("gelu_poly_bwd_cuda", x=x, dy=dy)
    x, dy = x.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    launch("gelu_poly_bwd_cuda", x.device, _library().bvc_gelu_poly_bwd, x.data_ptr(),
           dy.data_ptr(), dx.data_ptr(), x.numel())
    gelu_poly_cuda.launches_bwd += 1
    return dx


gelu_poly_cuda.launches = 0
gelu_poly_cuda.launches_bwd = 0


def _check_shapes(caller: str, **tensors: torch.Tensor) -> None:
    """What the fakes check, from metadata alone: tensors of one shape; for
    CUDA tensors also what the kernels need (:func:`_check_kernel_inputs`)."""
    first = next(iter(tensors.values()))
    if first.is_cuda:
        _check_kernel_inputs(caller, **tensors)
    elif any(x.shape != first.shape for x in tensors.values()):
        raise ValueError(f"{caller}: {', '.join(tensors)} differ in shape")


@torch.library.custom_op("bvc_tpu_torch::gelu_poly", mutates_args=(), device_types="cpu",
                         schema="(Tensor x) -> Tensor")
def gelu_poly_op(x):
    """:func:`gelu_poly` on CPU tensors (contiguous out, as the kernel
    writes it), :func:`gelu_poly_cuda` on CUDA ones."""
    return gelu_poly(x).contiguous()


gelu_poly_op.register_kernel("cuda")(gelu_poly_cuda)


@gelu_poly_op.register_fake
def _gelu_poly_fake(x):
    _check_shapes("gelu_poly", x=x)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@torch.library.custom_op("bvc_tpu_torch::gelu_poly_bwd", mutates_args=(), device_types="cpu",
                         schema="(Tensor x, Tensor dy) -> Tensor")
def gelu_poly_bwd_op(x, dy):
    """:func:`gelu_poly_bwd_ref` on CPU tensors (contiguous out),
    :func:`gelu_poly_bwd_cuda` on CUDA ones."""
    return gelu_poly_bwd_ref(x, dy).contiguous()


gelu_poly_bwd_op.register_kernel("cuda")(gelu_poly_bwd_cuda)


@gelu_poly_bwd_op.register_fake
def _gelu_poly_bwd_fake(x, dy):
    _check_shapes("gelu_poly_bwd", x=x, dy=dy)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _save_x(ctx, inputs, output) -> None:
    ctx.save_for_backward(inputs[0])


def _gelu_poly_grad(ctx, dy):
    (x,) = ctx.saved_tensors
    return gelu_poly_bwd_op(x, dy)


gelu_poly_op.register_autograd(_gelu_poly_grad, setup_context=_save_x)


def gelu(x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Erf-GELU.  ``impl``: ``'auto'`` (polynomial below f32, exact erf
    otherwise), ``'exact'`` or ``'poly'``; the polynomial of a bf16 tensor
    is :data:`gelu_poly_op`, of any other the eager chain.  A ``bvc::gelu``
    range while a profiler records."""
    if impl == "auto":
        impl = "poly" if torch.finfo(x.dtype).bits < 32 else "exact"
    if impl not in ("poly", "exact"):
        raise ValueError(f"unknown gelu impl {impl!r}")
    with profiler_range("gelu"):
        if impl == "exact":
            return F.gelu(x, approximate="none")
        return gelu_poly_op(x) if x.dtype == torch.bfloat16 else gelu_poly(x)
