"""Flash attention: hand-written CUDA kernels and their plain versions.

Counterpart of :mod:`bvc_tpu.ops.flash_attention` (``_fwd_kernel``,
``_dq_kernel``, ``_dkv_kernel``, ``_bwd``, the ``_flash`` custom VJP and
``flash_attention``), for non-causal attention without a key mask over
pre-scaled queries ``qs``.

- Forward, ``csrc/flash_fwd.cu``: online softmax with f32 accumulation; O in
  the input dtype and LSE = m + log(l) in f32.
- Backward, ``csrc/flash_bwd.cu``: a dQ kernel and a dK/dV kernel, from
  (qs, k, v, o, lse, dO) and D = rowsum(dO * O) taken in f32 outside the
  kernels, as ``_bwd`` does.

:func:`flash_fwd_cuda` and :func:`flash_bwd_cuda` launch the kernels for
CUDA tensors and count their launches (``flash_fwd_cuda.launches``,
``flash_bwd_cuda.launches_dq`` and ``.launches_dkv``).
:func:`flash_attention_fwd_ref` and :func:`flash_attention_bwd_ref` are the
plain PyTorch versions of the same arithmetic: the CPU tests use them, and
``chip_smoke.py`` holds the kernels against them on the card.
:func:`flash_attention_fwd` and :func:`flash_attention_bwd` pick between the
two by the tensors' device only.  :func:`flash_attention` is the public
``[B, N, h, d]`` entry, differentiable through :class:`FlashAttention`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

HEAD_DIM = 64  # the kernel's only head width


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in f32, ``[B, h, N]`` contiguous."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


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


def flash_attention_bwd_ref(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels over ``[B, N, h, d]`` tensors
    and ``lse [B, h, N]``: f32 scores, P = exp(S - lse), D = rowsum(dO * O),
    dS = P * (dO V^T - D); P rounded to the value dtype before the dV
    product and dS to the query dtype before the dQ and dK products, f32
    sums.  Returns ``(dqs, dk, dv)`` in the dtypes of ``qs``, ``k``, ``v``."""
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - _delta(o, do)[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), do.float())
    ds = ds.to(qs.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs.float())
    return dq.to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu``, built if needed, with its entry points typed:
    pointers and the stream as ``void*``, sizes and strides as ``long long``."""
    from bvc_tpu_torch.ops._build import load_library

    lib = load_library(name)
    signatures = {
        "flash_fwd": {"bvc_flash_fwd_d64": (5, 15)},
        "flash_bwd": {"bvc_flash_bwd_dq_d64": (7, 18),
                      "bvc_flash_bwd_dkv_d64": (8, 21)},
    }[name]
    for fn_name, (pointers, longs) in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_longlong] * longs
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


def _check_kernel_inputs(caller: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a 4-D CUDA bf16 ``[B, N, h, 64]``
    tensor of one shape on one device."""
    first = next(iter(tensors.values()))
    for name, x in tensors.items():
        if not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 4:
            raise ValueError(f"{caller}: {name} must be a 4-D CUDA bf16 "
                             f"tensor, got {x.dtype} {tuple(x.shape)} on {x.device}")
        if x.shape != first.shape or x.device != first.device:
            raise ValueError(f"{caller}: {', '.join(tensors)} differ in shape or device")
    if first.shape[-1] != HEAD_DIM:
        raise ValueError(f"{caller}: head width {first.shape[-1]} is not supported "
                         f"(the kernels are built for d={HEAD_DIM})")


def _launch(caller: str, device: torch.device, fn, *args) -> None:
    """Call a kernel's C entry point on the current stream of ``device``;
    raise if the launch failed."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{caller}: kernel launch failed with CUDA error {rc}")


def _strides(*tensors: torch.Tensor) -> list[int]:
    """(batch, token, head) strides of each ``[B, N, h, d]`` tensor."""
    return [s for x in tensors for s in x.stride()[:3]]


def flash_fwd_cuda(qs: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu`` on CUDA bf16 ``[B, N, h, 64]`` tensors
    (``qs`` pre-scaled) on the current stream; returns ``(o, lse)`` like
    :func:`flash_attention_fwd_ref`.  Raises on anything the kernel does not
    take, and if the launch fails."""
    _check_kernel_inputs("flash_fwd_cuda", qs=qs, k=k, v=v)
    B, N, h, d = qs.shape
    o = torch.empty((B, N, h, d), dtype=qs.dtype, device=qs.device)
    lse = torch.empty((B, h, N), dtype=torch.float32, device=qs.device)
    if o.numel() == 0:
        return o, lse
    qs, k, v = _kernel_layout(qs), _kernel_layout(k), _kernel_layout(v)
    _launch("flash_fwd_cuda", qs.device, _library("flash_fwd").bvc_flash_fwd_d64,
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, N, h, *_strides(qs, k, v, o))
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def bwd_operands(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                 lse: torch.Tensor, do: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The operands ``(qs, k, v, do, lse, delta)`` of the backward kernels:
    inputs checked, q/k/v/dO in a layout the kernels read (copied only where
    needed), D = rowsum(dO * O) in f32."""
    _check_kernel_inputs("flash_bwd_cuda", qs=qs, k=k, v=v, o=o, do=do)
    B, N, h, _ = qs.shape
    if (not lse.is_cuda or lse.dtype != torch.float32 or lse.shape != (B, h, N)
            or not lse.is_contiguous()):
        raise ValueError(f"flash_bwd_cuda: lse must be a contiguous CUDA f32 "
                         f"tensor of shape {(B, h, N)}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    return (*(_kernel_layout(x) for x in (qs, k, v, do)), lse, _delta(o, do))


def launch_dq(qs, k, v, do, lse, delta) -> torch.Tensor:
    """dQs from :func:`bwd_operands`: one launch of the dQ kernel."""
    B, N, h, d = qs.shape
    dq = torch.empty((B, N, h, d), dtype=qs.dtype, device=qs.device)
    _launch("flash_bwd_cuda", qs.device, _library("flash_bwd").bvc_flash_bwd_dq_d64,
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), B, N, h, *_strides(qs, k, v, do, dq))
    flash_bwd_cuda.launches_dq += 1
    return dq


def launch_dkv(qs, k, v, do, lse, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) from :func:`bwd_operands`: one launch of the dK/dV kernel."""
    B, N, h, d = qs.shape
    dk, dv = (torch.empty((B, N, h, d), dtype=qs.dtype, device=qs.device) for _ in range(2))
    _launch("flash_bwd_cuda", qs.device, _library("flash_bwd").bvc_flash_bwd_dkv_d64,
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, N, h,
            *_strides(qs, k, v, do, dk, dv))
    flash_bwd_cuda.launches_dkv += 1
    return dk, dv


def flash_bwd_cuda(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                   lse: torch.Tensor, do: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the two kernels of ``csrc/flash_bwd.cu`` on CUDA bf16
    ``[B, N, h, 64]`` tensors and ``lse [B, h, N]`` f32 on the current
    stream; returns ``(dqs, dk, dv)`` like :func:`flash_attention_bwd_ref`.
    qs/k/v and dO are read through their strides, copied only where their
    layout needs it; O enters only through D.  Raises on anything the
    kernels do not take, and if a launch fails.  Counts the launches of each
    kernel in ``.launches_dq`` and ``.launches_dkv``."""
    operands = bwd_operands(qs, k, v, o, lse, do)
    if qs.numel() == 0:
        return tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                     for x in (qs, k, v))
    return (launch_dq(*operands), *launch_dkv(*operands))


flash_bwd_cuda.launches_dq = 0
flash_bwd_cuda.launches_dkv = 0


def flash_attention_fwd(qs: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of pre-scaled attention: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if qs.is_cuda:
        return flash_fwd_cuda(qs, k, v)
    if qs.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not {qs.device}")
    return flash_attention_fwd_ref(qs, k, v)


def flash_attention_bwd(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dqs, dk, dv)``: the kernels for CUDA tensors, the plain version
    for CPU tensors."""
    if qs.is_cuda:
        return flash_bwd_cuda(qs, k, v, o, lse, do)
    if qs.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not {qs.device}")
    return flash_attention_bwd_ref(qs, k, v, o, lse, do)


class FlashAttention(torch.autograd.Function):
    """O of pre-scaled attention, with the backward kernels as its
    gradient (the JAX package's ``_flash`` custom VJP): the forward saves
    ``(qs, k, v, o, lse)``."""

    @staticmethod
    def forward(ctx, qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        o, lse = flash_attention_fwd(qs, k, v)
        ctx.save_for_backward(qs, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        return flash_attention_bwd(*ctx.saved_tensors, do)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Attention over ``[B, N, h, d]`` q/k/v, differentiable.

    The scale is folded into the queries outside the kernels, as the JAX
    package does: ``qs = (q * scale).to(q.dtype)``, so autograd carries it
    into dQ and dK gets none.  Key masks go to the key-bias kernels, which
    come with JEPA (ROADMAP slice 4); callers with a mask use
    :func:`bvc_tpu_torch.ops.attention.plain_attention`.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qs = (q * scale).to(q.dtype)
    return FlashAttention.apply(qs, k, v)
