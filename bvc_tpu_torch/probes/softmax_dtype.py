"""The softmax-dtype probe: counterpart of ``tools/probe_softmax_dtype.py``.

Does computing the attention scores in bf16 rather than f32 buy time in a
forward pass?  The probe times one attention forward with f32 and with bf16
score arithmetic, kernel and plain attention alike, and reads out the
largest ``|O_bf16 - O_f32|``.

- :func:`softmax_probe_fwd_cuda`: ``csrc/softmax_probe.cu``, the counterpart
  of the probe's ``_fwd_kernel`` (a single-pass forward over the full K/V of
  each query block, not the online softmax of ``flash_fwd``), on bf16
  ``[B, h, N, 64]`` tensors with pre-scaled queries, any N; it counts its
  launches in ``.launches``.  :func:`softmax_probe_fwd_ref` is its plain
  version.
- :func:`xla_attn`: the probe's plain attention with a selectable logits
  dtype, which normalises P before the P V product (the kernel divides
  after it).

Run on the card::

    python -m bvc_tpu_torch.probes.softmax_dtype

prints one JSON line for the plain attention at the JEPA target encoder's
``[64, 12, 392, 64]``, then one for the kernel at each of ``[64, 12, 512,
64]`` (the JEPA target as the TPU padded it), ``[64, 12, 392, 64]`` (its
real N) and ``[48, 6, 1568, 64]`` (the VideoMAE decoder): device ms with f32
and bf16 scores and the largest |O_bf16 - O_f32|.
"""

from __future__ import annotations

import ctypes
import functools
import json

import numpy as np
import torch

from bvc_tpu_torch.ops._build import kernel_layout, launch, load_library
from bvc_tpu_torch.utils.device import cuda_time_ms, resolve_device

HEAD_DIM = 64  # the kernel's only head width
SCORE_DTYPES = (torch.float32, torch.bfloat16)
XLA_SHAPE = (64, 12, 392, 64)
KERNEL_SHAPES = ((64, 12, 512, 64), (64, 12, 392, 64), (48, 6, 1568, 64))


def _check_score_dtype(score_dtype: torch.dtype) -> None:
    if score_dtype not in SCORE_DTYPES:
        raise ValueError(f"score_dtype must be one of {SCORE_DTYPES}, got {score_dtype}")


def softmax_probe_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          score_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the kernel over ``[B, h, N, d]`` with pre-scaled
    ``q``: scores in f32 (rounded to ``score_dtype``), m = max, p = exp(s - m)
    in the score dtype, l = sum p in f32, O = (p in v's dtype) V summed in
    f32, divided by l, in q's dtype."""
    _check_score_dtype(score_dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()).to(score_dtype)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.float().sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (acc / l).to(q.dtype)


def xla_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             score_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The probe's plain attention over ``[B, h, N, d]``: logits in
    ``score_dtype``, p = exp(logits - max), l = sum p in f32, probabilities
    p / l in q's dtype, then their product with V in q's dtype."""
    _check_score_dtype(score_dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()).to(score_dtype)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    l = p.float().sum(dim=-1, keepdim=True)
    probs = (p / l.to(p.dtype)).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float()).to(q.dtype)


_SIGNATURES = {"bvc_softmax_probe_fwd": (4, 17)}  # (void*, long long)


@functools.cache
def _library() -> ctypes.CDLL:
    """``csrc/softmax_probe.cu``, built if needed, with its entry point typed."""
    return load_library("softmax_probe", _SIGNATURES)


def softmax_probe_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           score_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch ``csrc/softmax_probe.cu`` on CUDA bf16 ``[B, h, N, 64]``
    tensors (``q`` pre-scaled) on the current stream; returns O like
    :func:`softmax_probe_fwd_ref`.  Raises on anything the kernel does not
    take, and if the launch fails.  Counts launches in ``.launches``."""
    caller = "softmax_probe_fwd_cuda"
    _check_score_dtype(score_dtype)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 4:
            raise ValueError(f"{caller}: {name} must be a 4-D CUDA bf16 tensor, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if x.shape != q.shape or x.device != q.device:
            raise ValueError(f"{caller}: q, k, v differ in shape or device")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"{caller}: head width {q.shape[-1]} is not supported "
                         f"(the kernel is built for d = {HEAD_DIM})")
    B, h, N, d = q.shape
    o = torch.empty((B, h, N, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    q, k, v = kernel_layout(q), kernel_layout(k), kernel_layout(v)
    strides = [s for x in (q, k, v, o) for s in x.stride()[:3]]
    launch(caller, q.device, _library().bvc_softmax_probe_fwd, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), o.data_ptr(), B, h, N, d, int(score_dtype == torch.bfloat16),
           *strides)
    softmax_probe_fwd_cuda.launches += 1
    return o


softmax_probe_fwd_cuda.launches = 0


def probe_inputs(shape: tuple[int, int, int, int], rng: np.random.Generator,
                 device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The probe's inputs: q ~ N(0, 1) x 0.125 (pre-scaled at d = 64), k, v ~
    N(0, 1), bf16."""
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale)
               for scale in (0.125, 1.0, 1.0))
    return tuple(x.to(device, torch.bfloat16) for x in (q, k, v))


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def run() -> list[dict]:
    """The probe's readings on the card, one dict per line of :func:`main`."""
    device = resolve_device()
    rng = np.random.default_rng(0)
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}
    q, k, v = probe_inputs(XLA_SHAPE, rng, device)
    line = {"impl": "xla", "shape": list(XLA_SHAPE)}
    for sd in SCORE_DTYPES:
        line[names[sd]] = cuda_time_ms(lambda: xla_attn(q, k, v, sd), iters=5)
    line["max_abs_err"] = _max_abs(xla_attn(q, k, v, torch.float32),
                                   xla_attn(q, k, v, torch.bfloat16))
    lines = [line]
    for shape in KERNEL_SHAPES:
        q, k, v = probe_inputs(shape, rng, device)
        line = {"impl": "kernel", "shape": list(shape)}
        for sd in SCORE_DTYPES:
            line[names[sd]] = cuda_time_ms(lambda: softmax_probe_fwd_cuda(q, k, v, sd))
        line["max_abs_err"] = _max_abs(softmax_probe_fwd_cuda(q, k, v, torch.float32),
                                       softmax_probe_fwd_cuda(q, k, v, torch.bfloat16))
        lines.append(line)
    return lines


def main() -> None:
    for line in run():
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
