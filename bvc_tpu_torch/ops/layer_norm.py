"""LayerNorm over the last axis with f32 statistics, as an operator with a
kernel for bf16 activations on the card.

:func:`layer_norm` (the models' LayerNorm, :func:`bvc_tpu_torch.models.vit.layer_norm`;
the counterpart of the JAX package's ``layer_norm`` in :mod:`bvc_tpu.models.vit`)
chooses between the operator and :func:`layer_norm_chain`, the eager chain::

    mean = mean(x);  var = mean((x - mean)^2);  rstd = rsqrt(var + eps)
    y = (x - mean) * rstd;  y = y * weight + bias   (weight/bias None: unit affine)

in f32 whatever the input dtype, cast back to it.  On the TPU XLA fused it;
in eager PyTorch it is about a dozen f32 passes forward and twenty autograd
nodes backward, which keep about three f32 copies of the input.

The operator ``torch.ops.bvc_tpu_torch.layer_norm(x, weight?, bias?, eps)
-> (y, mean, rstd)`` (:data:`layer_norm_op`; ``mean`` and ``rstd`` f32 of
shape ``[rows]``, ``rows`` the product of ``x``'s leading dimensions) has
the gradient ``.layer_norm_bwd(dy, x, weight?, mean, rstd) -> (dx, dweight?,
dbias?)`` (:data:`layer_norm_bwd_op`), for which only ``x`` and the two f32
row vectors are saved (and the weight, a parameter).  On CUDA tensors they
launch ``csrc/layer_norm.cu``: the forward one pass over memory, the
backward one pass and a small fixed-order sum of the CTAs' column sums for
dweight and dbias (no atomics: they repeat bit for bit);
:func:`layer_norm_cuda` counts their launches in ``.launches`` and
``.launches_bwd``.  The kernel's statistics sum in another order than
PyTorch's mean, so its ``y`` is the chain's but where a last bit of the
statistics moves a value across a bf16 rounding boundary (by one bf16 ulp).
On CPU tensors the forward is the eager chain bit for bit and the backward
:func:`layer_norm_bwd_ref`, the closed form in f32::

    xhat = (x - mean) * rstd;  g = dy * weight
    dx = rstd * (g - mean(g) - xhat * mean(g * xhat))
    dweight = sum over rows of dy * xhat;  dbias = sum over rows of dy

:func:`layer_norm_route` says which inputs the kernel takes: CUDA bf16
tensors whose width is a multiple of 8 up to :data:`LAYER_NORM_MAX_WIDTH`;
:func:`layer_norm` sends every other input down the eager chain.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from bvc_tpu_torch.ops._build import launch, load_library
from bvc_tpu_torch.utils.profiling import profiler_range

# the widest row the kernels take: 8 warps x 32 lanes x 4 pieces of 8 bf16
LAYER_NORM_MAX_WIDTH = 8192
# the backward's CTAs a streaming multiprocessor, the size of its scratch
_BWD_CTAS_PER_SM = 2


def layer_norm_route(device_type: str, dtype: torch.dtype, width: int) -> str:
    """``'kernel'`` for a CUDA bf16 input of ``width`` a multiple of 8 up to
    :data:`LAYER_NORM_MAX_WIDTH`, else ``'chain'`` (the eager chain)."""
    takes = (device_type == "cuda" and dtype == torch.bfloat16 and width % 8 == 0
             and 0 < width <= LAYER_NORM_MAX_WIDTH)
    return "kernel" if takes else "chain"


def _chain(x: torch.Tensor, weight: torch.Tensor | None, bias: torch.Tensor | None,
           eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd
    if weight is not None:
        y = y * weight + bias
    return y.to(x.dtype), mean, rstd


def layer_norm_chain(x: torch.Tensor, weight: torch.Tensor | None,
                     bias: torch.Tensor | None, eps: float) -> torch.Tensor:
    """The eager chain: f32 statistics and affine, cast back to ``x``'s
    dtype; differentiable through autograd."""
    return _chain(x, weight, bias, eps)[0]


def layer_norm_bwd_ref(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor | None,
                       mean: torch.Tensor, rstd: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """``(dx, dweight, dbias)`` of the chain at ``x`` for the output
    gradient ``dy``, from the forward's ``mean`` and ``rstd`` ``[rows]``: the
    closed form in f32, dx in ``x``'s dtype; dweight and dbias f32 ``[D]``,
    None without a weight."""
    stat = x.shape[:-1] + (1,)
    xhat = (x.float() - mean.reshape(stat)) * rstd.reshape(stat)
    dyf = dy.float()
    g = dyf if weight is None else dyf * weight
    dx = rstd.reshape(stat) * (g - g.mean(dim=-1, keepdim=True)
                               - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    if weight is None:
        return dx.to(x.dtype), None, None
    lead = tuple(range(x.ndim - 1))
    return dx.to(x.dtype), (dyf * xhat).sum(lead), dyf.sum(lead)


# the library in csrc/ that each custom operator's CUDA side launches
OP_LIBRARIES = {"layer_norm": "layer_norm", "layer_norm_bwd": "layer_norm"}
# (void*, long long, double) arguments of each entry point
_SIGNATURES = {"bvc_layer_norm_fwd": (6, 2, 1), "bvc_layer_norm_bwd": (9, 3)}


@functools.cache
def _library() -> ctypes.CDLL:
    """``csrc/layer_norm.cu``, built if needed, with its entry points typed."""
    return load_library("layer_norm", _SIGNATURES)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(caller: str, x: torch.Tensor, weight: torch.Tensor | None,
           bias: torch.Tensor | None, *same_as_x: torch.Tensor, kernel: bool) -> None:
    """What the fakes check, from metadata alone: ``same_as_x`` of ``x``'s
    shape, dtype and device, a weight (and a bias, if one is given) f32 of
    shape ``[D]`` on ``x``'s device; with ``kernel`` also what the kernels
    take (a CUDA bf16 ``x`` of :func:`layer_norm_route`'s widths)."""
    if x.ndim == 0:
        raise ValueError(f"{caller}: x must have a last axis")
    width = x.shape[-1]
    if kernel and layer_norm_route(x.device.type, x.dtype, width) != "kernel":
        raise ValueError(f"{caller}: x must be a CUDA bf16 tensor of width a multiple of 8 up "
                         f"to {LAYER_NORM_MAX_WIDTH}, got {x.dtype} of width {width} on "
                         f"{x.device}")
    for t in same_as_x:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{caller}: tensors differ from x in shape, dtype or device")
    for name, p in (("weight", weight), ("bias", bias)):
        if p is not None and (p.shape != (width,) or p.dtype != torch.float32
                              or p.device != x.device):
            raise ValueError(f"{caller}: {name} must be f32 of shape [{width}] on x's device, "
                             f"got {p.dtype} {tuple(p.shape)} on {p.device}")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and starting on 16 bytes, as the kernels read it."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def layer_norm_cuda(x: torch.Tensor, weight: torch.Tensor | None, bias: torch.Tensor | None,
                    eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``csrc/layer_norm.cu``'s forward on a CUDA bf16 ``x`` on the
    current stream: ``(y, mean, rstd)``, ``y`` contiguous bf16 of ``x``'s
    shape, ``mean`` and ``rstd`` f32 ``[rows]``.  ``weight`` and ``bias``
    both f32 ``[D]`` or both None.  Raises on any other input and if the
    launch fails; launches nothing for an empty ``x``.  Counts launches in
    ``.launches``."""
    _check("layer_norm_cuda", x, weight, bias, kernel=True)
    if (weight is None) != (bias is None):
        raise ValueError("layer_norm_cuda: weight and bias are both given or both None")
    x = _rows(x)
    rows = x.numel() // x.shape[-1]
    y = torch.empty_like(x)
    mean, rstd = (torch.empty(rows, dtype=torch.float32, device=x.device) for _ in range(2))
    if rows == 0:
        return y, mean, rstd
    w, b = (None if p is None else _rows(p) for p in (weight, bias))  # held until queued
    launch("layer_norm_cuda", x.device, _library().bvc_layer_norm_fwd, x.data_ptr(),
           _ptr(w), _ptr(b), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), rows,
           x.shape[-1], float(eps))
    layer_norm_cuda.launches += 1
    return y, mean, rstd


def layer_norm_bwd_cuda(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor | None,
                        mean: torch.Tensor, rstd: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """Launch ``csrc/layer_norm.cu``'s backward on CUDA bf16 ``dy`` and
    ``x`` of one shape on the current stream: ``(dx, dweight, dbias)`` as
    :func:`layer_norm_bwd_ref` gives them (dx contiguous).  Raises on any
    other input and if the launch fails; launches nothing for an empty
    ``x`` (dweight and dbias are then zeros).  Counts launches in
    ``layer_norm_cuda.launches_bwd``."""
    _check("layer_norm_bwd_cuda", x, weight, None, dy, kernel=True)
    d = x.shape[-1]
    rows = x.numel() // d
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.shape != (rows,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"layer_norm_bwd_cuda: {name} must be f32 [{rows}] on x's device")
    # every tensor the launch reads, held until it is queued
    x, dy, mean, rstd = (_rows(t) for t in (x, dy, mean, rstd))
    w = None if weight is None else _rows(weight)
    dx = torch.empty_like(x)
    dw = db = partial = None
    max_ctas = _BWD_CTAS_PER_SM * _sm_count(x.device)
    if w is not None:
        partial = torch.empty((max_ctas, 2, d), dtype=torch.float32, device=x.device)
        dw, db = (torch.empty(d, dtype=torch.float32, device=x.device) for _ in range(2))
    if rows == 0:
        return dx, *(None if t is None else t.zero_() for t in (dw, db))
    launch("layer_norm_bwd_cuda", x.device, _library().bvc_layer_norm_bwd, dy.data_ptr(),
           x.data_ptr(), _ptr(w), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
           _ptr(partial), _ptr(dw), _ptr(db), rows, d, max_ctas)
    layer_norm_cuda.launches_bwd += 1
    return dx, dw, db


layer_norm_cuda.launches = 0
layer_norm_cuda.launches_bwd = 0


@torch.library.custom_op("bvc_tpu_torch::layer_norm", mutates_args=(), device_types="cpu",
                         schema="(Tensor x, Tensor? weight, Tensor? bias, float eps) -> "
                                "(Tensor, Tensor, Tensor)")
def layer_norm_op(x, weight, bias, eps):
    """``(y, mean, rstd)``: the eager chain on CPU tensors (outputs
    contiguous, the statistics flattened to ``[rows]``),
    :func:`layer_norm_cuda` on CUDA ones."""
    y, mean, rstd = _chain(x, weight, bias, eps)
    return y.contiguous(), mean.reshape(-1).contiguous(), rstd.reshape(-1).contiguous()


layer_norm_op.register_kernel("cuda")(layer_norm_cuda)


@layer_norm_op.register_fake
def _layer_norm_fake(x, weight, bias, eps):
    _check("layer_norm", x, weight, bias, kernel=x.is_cuda)
    rows = math.prod(x.shape[:-1])
    stat = x.new_empty((rows,), dtype=torch.float32)
    return (torch.empty_like(x, memory_format=torch.contiguous_format), stat,
            torch.empty_like(stat))


@torch.library.custom_op("bvc_tpu_torch::layer_norm_bwd", mutates_args=(), device_types="cpu",
                         schema="(Tensor dy, Tensor x, Tensor? weight, Tensor mean, "
                                "Tensor rstd) -> (Tensor, Tensor?, Tensor?)")
def layer_norm_bwd_op(dy, x, weight, mean, rstd):
    """``(dx, dweight, dbias)``: :func:`layer_norm_bwd_ref` on CPU tensors
    (dx contiguous), :func:`layer_norm_bwd_cuda` on CUDA ones."""
    dx, dw, db = layer_norm_bwd_ref(dy, x, weight, mean, rstd)
    return dx.contiguous(), dw, db


layer_norm_bwd_op.register_kernel("cuda")(layer_norm_bwd_cuda)


@layer_norm_bwd_op.register_fake
def _layer_norm_bwd_fake(dy, x, weight, mean, rstd):
    _check("layer_norm_bwd", x, weight, None, dy, kernel=x.is_cuda)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    if weight is None:
        return dx, None, None
    return dx, torch.empty_like(weight), torch.empty_like(weight)


def _save(ctx, inputs, output) -> None:
    x, weight, _, _ = inputs
    _, mean, rstd = output
    ctx.save_for_backward(x, weight, mean, rstd)
    ctx.mark_non_differentiable(mean, rstd)


def _layer_norm_grad(ctx, dy, _dmean, _drstd):
    x, weight, mean, rstd = ctx.saved_tensors
    return (*layer_norm_bwd_op(dy, x, weight, mean, rstd), None)


layer_norm_op.register_autograd(_layer_norm_grad, setup_context=_save)


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None,
               bias: torch.Tensor | None, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics, cast back to the
    input dtype; ``weight``/``bias`` None is the unit affine.  An input that
    :func:`layer_norm_route` gives the kernel (CUDA bf16 of a width it
    takes) goes through :data:`layer_norm_op`, every other (CPU, f32, f16)
    through :func:`layer_norm_chain`.  A ``bvc::layer_norm`` range while a
    profiler records."""
    with profiler_range("layer_norm"):
        if layer_norm_route(x.device.type, x.dtype, x.shape[-1]) == "kernel":
            return layer_norm_op(x, weight, bias, eps)[0]
        return layer_norm_chain(x, weight, bias, eps)
