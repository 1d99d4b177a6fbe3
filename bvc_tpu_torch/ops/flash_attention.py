"""Forward flash attention: a hand-written CUDA kernel and its plain version.

Counterpart of :mod:`bvc_tpu.ops.flash_attention`'s forward
(``_fwd_kernel``, ``_fwd``, ``flash_attention``).  The kernel,
``csrc/flash_fwd.cu``, computes non-causal attention over pre-scaled bf16
queries with online softmax and f32 accumulation, and returns O in bf16 and
LSE = m + log(l) in f32 (kept for the backward kernels of a later slice).

- :func:`flash_fwd_cuda` launches the kernel for CUDA tensors and counts its
  launches in ``flash_fwd_cuda.launches``.
- :func:`flash_attention_fwd_ref` is the plain PyTorch version of the same
  arithmetic: the CPU tests use it, and ``chip_smoke.py`` holds the kernel
  against it on the card.
- :func:`flash_attention_fwd` picks between them by the tensors' device
  only; :func:`flash_attention` is the public ``[B, N, h, d]`` entry.

Forward only: the backward kernels come with the training slice, so a call
that would need a gradient raises instead of differentiating the plain path.
"""

from __future__ import annotations

import ctypes
import functools

import torch

HEAD_DIM = 64  # the kernel's only head width


def flash_attention_fwd_ref(qs: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel over ``[B, N, h, d]`` tensors with
    pre-scaled queries ``qs``: f32 scores, f32 softmax statistics, P rounded
    to the value dtype before the P.V product with f32 accumulation.
    Returns ``(o [B, N, h, d] in the input dtype, lse [B, h, N] f32)``."""
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = acc / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).squeeze(-1)
    return o.to(qs.dtype), lse


@functools.cache
def _library() -> ctypes.CDLL:
    from bvc_tpu_torch.ops._build import load_library

    lib = load_library("flash_fwd")
    fn = lib.bvc_flash_fwd_d64
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 15
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """The kernel reads ``[B, N, h, d]`` through its strides (so the
    strided q/k/v slices of a fused qkv tensor go in without a copy) as long
    as the head width is contiguous and every row starts on 16 bytes; any
    other layout is copied into a fresh (aligned) contiguous tensor first —
    ``contiguous()`` alone would keep a contiguous view that starts off the
    16-byte grid."""
    aligned = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
               and all(s % 8 == 0 for s in x.stride()[:-1]))
    return x if aligned else x.clone(memory_format=torch.contiguous_format)


def flash_fwd_cuda(qs: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu`` on CUDA bf16 ``[B, N, h, 64]`` tensors
    (``qs`` pre-scaled) on the current stream; returns ``(o, lse)`` like
    :func:`flash_attention_fwd_ref`.  Raises on anything the kernel does not
    take, and if the launch fails."""
    for name, x in (("qs", qs), ("k", k), ("v", v)):
        if not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 4:
            raise ValueError(f"flash_fwd_cuda: {name} must be a 4-D CUDA bf16 "
                             f"tensor, got {x.dtype} {tuple(x.shape)} on {x.device}")
        if x.shape != qs.shape or x.device != qs.device:
            raise ValueError("flash_fwd_cuda: qs, k and v differ in shape or device")
    B, N, h, d = qs.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash_fwd_cuda: head width {d} is not supported "
                         f"(the kernel is built for d={HEAD_DIM})")
    o = torch.empty((B, N, h, d), dtype=qs.dtype, device=qs.device)
    lse = torch.empty((B, h, N), dtype=torch.float32, device=qs.device)
    if o.numel() == 0:
        return o, lse
    qs, k, v = _kernel_layout(qs), _kernel_layout(k), _kernel_layout(v)
    strides = [s for x in (qs, k, v, o) for s in x.stride()[:3]]
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    with torch.cuda.device(qs.device):
        rc = _library().bvc_flash_fwd_d64(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, N, h, *strides, stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd_cuda: kernel launch failed with CUDA "
                           f"error {rc}")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def flash_attention_fwd(qs: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of pre-scaled attention: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if qs.is_cuda:
        return flash_fwd_cuda(qs, k, v)
    if qs.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not {qs.device}")
    return flash_attention_fwd_ref(qs, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Attention over ``[B, N, h, d]`` q/k/v, forward only.

    The scale is folded into the queries outside the kernel, as the JAX
    package does: ``qs = (q * scale).to(q.dtype)``.  Key masks go to the
    key-bias kernels, which come with JEPA (ROADMAP slice 4); callers with a
    mask use :func:`bvc_tpu_torch.ops.attention.plain_attention`.
    """
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError("backward kernels: ROADMAP slice 2")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qs = (q * scale).to(q.dtype)
    o, _ = flash_attention_fwd(qs, k, v)
    return o
