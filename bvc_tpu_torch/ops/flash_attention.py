"""Flash attention: hand-written CUDA kernels and their plain versions.

Counterpart of :mod:`bvc_tpu.ops.flash_attention` (``_fwd_kernel``,
``_dq_kernel``, ``_dkv_kernel``, their key-bias variants
``_fwd_kernel_bias``, ``_dq_kernel_bias`` and ``_dkv_kernel_bias``, ``_bwd``,
the ``_flash``/``_flash_b`` custom VJPs and ``flash_attention``), for
non-causal attention over pre-scaled queries ``qs``, without a key mask or
with a per-sample key bias.

- Forward, ``csrc/flash_fwd.cu`` on the Hopper mainloop of
  ``csrc/attn_sm90.cuh``: online softmax with f32 accumulation; O in the
  input dtype and LSE = m + log(l) in f32.  With a key bias, key tiles
  whose keys are all masked are skipped.
- Backward, ``csrc/flash_bwd_sm90.cu``, with or without a key bias: a
  pre-pass for D = rowsum(dO * O) in f32, one kernel for the five products
  (dK and dV stored, dQs summed over key tiles in an f32 accumulator by TMA
  reductions, adds in L2 whose order varies from run to run; with a bias a
  key tile whose keys are all masked writes zero dK and dV and adds
  nothing) and a post-pass that writes dQs in bf16.
- Key bias: ``bias`` is ``[B, N]`` f32, 0 for a key that may be attended
  and -1e30 (:data:`NEG_INF`) for a masked one, added to every score of
  the key's column in every head (:func:`key_bias` builds it from a bool
  key mask; the public functions take the mask, or the bias built once by
  name, ``bias=``).  A row whose every key is masked gets uniform weights over its
  N keys, as plain attention gives, and LSE = +inf, so the backward gives
  it no gradient; masked keys get dK = dV = 0 exactly.  The bias gets no
  gradient.

The unmasked kernels take head width 64 (:data:`HEAD_DIM`), the key-bias
kernels 64 and 32 (:data:`BIAS_HEAD_DIMS`).  :func:`flash_fwd_cuda` and
:func:`flash_bwd_cuda` launch the kernels for CUDA tensors and count their
launches: ``flash_fwd_cuda.launches`` and ``.launches_bias``,
``flash_bwd_cuda.launches_prep``, ``.launches_fused``, ``.launches_post``
without a bias and ``.launches_prep_bias``, ``.launches_fused_bias``,
``.launches_post_bias`` with one.
:func:`flash_attention_fwd_ref` and :func:`flash_attention_bwd_ref` are the
plain PyTorch versions of the same arithmetic: the CPU tests use them, and
``chip_smoke.py`` holds the kernels against them on the card.

PyTorch reaches both through two custom operators, ``torch.ops.bvc_tpu_torch
.flash_fwd(qs, k, v, bias?) -> (o, lse)`` and ``.flash_bwd(qs, k, v, o,
lse, do, bias?) -> (dqs, dk, dv)`` (:data:`flash_fwd`, :data:`flash_bwd`):
the kernels for CUDA tensors, the plain versions for CPU tensors, and fake
implementations that give the outputs' shapes without data, so that
``torch.export`` traces them as graph nodes and a saved program calls them
again.  ``flash_fwd``'s gradient is ``flash_bwd`` (the JAX package's
``_flash`` and ``_flash_b`` custom VJPs); the bias and LSE get none.
:func:`flash_attention_fwd` and :func:`flash_attention_bwd` are their
public names; :data:`OP_LIBRARIES` names the ``csrc/`` library behind each.
:func:`attention_tile_check` and :func:`bwd_tile_check` run the forward's
two and the backward's five Hopper products on one tile at head width 64 or
32, a first check on a new card.  :func:`flash_attention` is the public,
differentiable ``[B, N, h, d]`` entry.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bvc_tpu_torch.ops._build import kernel_layout, launch, load_library

HEAD_DIM = 64  # the unmasked kernels' only head width
BIAS_HEAD_DIMS = (64, 32)  # the key-bias kernels' head widths
NEG_INF = -1e30  # the bias of a masked key


def key_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` f32 key bias from a bool key mask (True = attendable):
    0 where a key may be attended, :data:`NEG_INF` where it is masked.
    Raises for a mask of any other dtype."""
    if key_mask.dtype != torch.bool:
        raise TypeError(f"key_mask must be a bool tensor (True = attendable), "
                        f"got {key_mask.dtype}")
    return torch.where(key_mask, 0.0, NEG_INF).to(torch.float32)


def resolve_bias(key_mask: torch.Tensor | None,
                 bias: torch.Tensor | None) -> torch.Tensor | None:
    """The key bias of an attention called with a bool ``key_mask`` or with
    ``bias``, a key bias already built by :func:`key_bias` (a stack of blocks
    builds it once for all its layers); None for neither, and raises for
    both."""
    if key_mask is None:
        return bias
    if bias is not None:
        raise ValueError("pass key_mask or bias, not both")
    return key_bias(key_mask)


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in f32, ``[B, h, N]`` contiguous."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _scores(qs: torch.Tensor, k: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """f32 ``[B, h, N, N]`` scores Qs K^T, plus the key bias if given."""
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    return s if bias is None else s + bias[:, None, None, :]


def flash_attention_fwd_ref(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernels over ``[B, N, h, d]`` tensors
    with pre-scaled queries ``qs`` and an optional ``[B, N]`` key bias: f32
    scores, f32 softmax statistics, P rounded to the value dtype before the
    P.V product with f32 accumulation.  Returns ``(o [B, N, h, d] in the
    input dtype, lse [B, h, N] f32)``; with a bias, a row with no attendable
    key (max score at or below :data:`NEG_INF`) has LSE = +inf."""
    s = _scores(qs, k, bias)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = acc / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).squeeze(-1)
    if bias is not None:
        lse = torch.where(m.squeeze(-1) <= NEG_INF, torch.inf, lse)
    return o.to(qs.dtype), lse


def flash_attention_bwd_ref(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                            bias: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels over ``[B, N, h, d]`` tensors,
    ``lse [B, h, N]`` and an optional ``[B, N]`` key bias: f32 scores,
    P = exp(S + bias - lse), D = rowsum(dO * O), dS = P * (dO V^T - D); P
    rounded to the value dtype before the dV product and dS to the query
    dtype before the dQ and dK products, f32 sums.  Returns ``(dqs, dk,
    dv)`` in the dtypes of ``qs``, ``k``, ``v``."""
    p = torch.exp(_scores(qs, k, bias) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - _delta(o, do)[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), do.float())
    ds = ds.to(qs.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs.float())
    return dq.to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype)


# the library in csrc/ that each custom operator's CUDA side launches
OP_LIBRARIES = {"flash_fwd": "flash_fwd", "flash_bwd": "flash_bwd_sm90"}
_SIGNATURES = {  # (void* arguments, long long arguments) of each entry point
    "flash_fwd": {"bvc_flash_fwd": (6, 16), "bvc_attn_tile_check": (5, 1)},
    "flash_bwd_sm90": {"bvc_flash_bwd_prep": (5, 11), "bvc_flash_bwd_sm90": (9, 23),
                       "bvc_flash_bwd_dq_store": (2, 8), "bvc_flash_bwd_tile_check": (9, 1)},
}


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu``, built if needed, with its entry points typed."""
    return load_library(name, _SIGNATURES[name])


def _check_kernel_inputs(caller: str, bias: torch.Tensor | None,
                         **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a 4-D CUDA bf16 ``[B, N, h, d]`` tensor
    of one shape on one device, with d = 64 (or, with a key bias, d in
    :data:`BIAS_HEAD_DIMS`), and ``bias``, if given, a contiguous CUDA f32
    ``[B, N]`` tensor on that device."""
    first = next(iter(tensors.values()))
    for name, x in tensors.items():
        if not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 4:
            raise ValueError(f"{caller}: {name} must be a 4-D CUDA bf16 "
                             f"tensor, got {x.dtype} {tuple(x.shape)} on {x.device}")
        if x.shape != first.shape or x.device != first.device:
            raise ValueError(f"{caller}: {', '.join(tensors)} differ in shape or device")
    widths = (HEAD_DIM,) if bias is None else BIAS_HEAD_DIMS
    if first.shape[-1] not in widths:
        kind = "key-bias kernels" if bias is not None else "kernels without a key mask"
        raise ValueError(f"{caller}: head width {first.shape[-1]} is not supported "
                         f"(the {kind} are built for d in {widths})")
    if bias is not None and (bias.device != first.device or bias.dtype != torch.float32
                             or bias.shape != first.shape[:2] or not bias.is_contiguous()):
        raise ValueError(f"{caller}: bias must be a contiguous CUDA f32 tensor of shape "
                         f"{tuple(first.shape[:2])} on {first.device}, got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")


def _strides(*tensors: torch.Tensor) -> list[int]:
    """(batch, token, head) strides of each ``[B, N, h, d]`` tensor."""
    return [s for x in tensors for s in x.stride()[:3]]


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def flash_fwd_cuda(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu`` on CUDA bf16 ``[B, N, h, d]`` tensors
    (``qs`` pre-scaled; d = 64, or 64 or 32 with a key ``bias``) on the
    current stream; returns ``(o, lse)`` like :func:`flash_attention_fwd_ref`.
    Raises on anything the kernels do not take, and if the launch fails.
    Counts launches of the unmasked kernel in ``.launches`` and of the
    key-bias kernel in ``.launches_bias``."""
    _check_kernel_inputs("flash_fwd_cuda", bias, qs=qs, k=k, v=v)
    B, N, h, d = qs.shape
    o = torch.empty((B, N, h, d), dtype=qs.dtype, device=qs.device)
    lse = torch.empty((B, h, N), dtype=torch.float32, device=qs.device)
    if o.numel() == 0:
        return o, lse
    qs, k, v = kernel_layout(qs), kernel_layout(k), kernel_layout(v)
    launch("flash_fwd_cuda", qs.device, _library("flash_fwd").bvc_flash_fwd,
           qs.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), o.data_ptr(),
           lse.data_ptr(), B, N, h, d, *_strides(qs, k, v, o))
    if bias is None:
        flash_fwd_cuda.launches += 1
    else:
        flash_fwd_cuda.launches_bias += 1
    return o, lse


flash_fwd_cuda.launches = 0
flash_fwd_cuda.launches_bias = 0


def _check_tile_inputs(caller: str, head_dim: int, shapes: dict[str, tuple[int, int]],
                       **tensors: torch.Tensor) -> None:
    if head_dim not in BIAS_HEAD_DIMS:
        raise ValueError(f"{caller}: head_dim must be one of {BIAS_HEAD_DIMS}, got {head_dim}")
    for name, x in tensors.items():
        if not x.is_cuda or x.dtype != torch.bfloat16 or tuple(x.shape) != shapes[name]:
            raise ValueError(f"{caller}: {name} must be a CUDA bf16 tensor of "
                             f"shape {shapes[name]}, got {x.dtype} {tuple(x.shape)}")


def attention_tile_check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         head_dim: int = HEAD_DIM) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels' two products on one tile at ``head_dim`` (64 or
    32), on the card: ``q [64, d]``, ``k`` and ``v [128, d]`` bf16 in,
    ``(s, o)`` f32 out with ``s = q k^T`` and ``o = bf16(s) v``, through the
    same TMA loads, swizzle and wgmma as the kernels.  A first check on a
    new card or toolkit, before anything runs on those products."""
    d = head_dim
    _check_tile_inputs("attention_tile_check", d, {"q": (64, d), "k": (128, d), "v": (128, d)},
                       q=q, k=k, v=v)
    q, k, v = (x.contiguous() for x in (q, k, v))
    s = torch.empty((64, 128), dtype=torch.float32, device=q.device)
    o = torch.empty((64, d), dtype=torch.float32, device=q.device)
    launch("attention_tile_check", q.device, _library("flash_fwd").bvc_attn_tile_check,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(), o.data_ptr(), d)
    return s, o


def _check_lse(lse: torch.Tensor, B: int, h: int, N: int) -> None:
    if (not lse.is_cuda or lse.dtype != torch.float32 or lse.shape != (B, h, N)
            or not lse.is_contiguous()):
        raise ValueError(f"flash_bwd_cuda: lse must be a contiguous CUDA f32 "
                         f"tensor of shape {(B, h, N)}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")


def padded_tokens(n: int) -> int:
    """Np: N rounded up to the backward's 64-query tile, the row count of
    its stats table and dQ accumulator."""
    return -(-n // 64) * 64


def bwd_operands(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                 lse: torch.Tensor, do: torch.Tensor, bias: torch.Tensor | None = None
                 ) -> dict[str, torch.Tensor | None]:
    """Everything the three kernels of ``csrc/flash_bwd_sm90.cu`` read and
    write, without or with a key ``bias``: the inputs checked and in a
    layout the kernels read (copied only where needed), the outputs ``dq``,
    ``dk``, ``dv``, and the scratch, a ``[B h, 2, Np]`` f32 stats table (L
    log2 e and D) and the ``[B, h, Np, d]`` f32 dQ accumulator, all
    allocated with ``torch.empty``."""
    _check_kernel_inputs("flash_bwd_cuda", bias, qs=qs, k=k, v=v, o=o, do=do)
    B, N, h, d = qs.shape
    _check_lse(lse, B, h, N)
    qs, k, v, o, do = (kernel_layout(x) for x in (qs, k, v, o, do))
    f32 = {"dtype": torch.float32, "device": qs.device}
    n_pad = padded_tokens(N)
    return {"qs": qs, "k": k, "v": v, "o": o, "do": do, "lse": lse, "bias": bias,
            "stats": torch.empty(B * h * 2 * n_pad, **f32),
            "dq_acc": torch.empty(B * h * n_pad * d, **f32),
            **{name: torch.empty((B, N, h, d), dtype=qs.dtype, device=qs.device)
               for name in ("dq", "dk", "dv")}}


def _dims(w: dict[str, torch.Tensor]) -> tuple[int, int, int, int, int]:
    B, N, h, d = w["qs"].shape
    return B, N, h, padded_tokens(N), d


def _count(w: dict[str, torch.Tensor | None], counter: str) -> None:
    if w["bias"] is not None:
        counter += "_bias"
    setattr(flash_bwd_cuda, counter, getattr(flash_bwd_cuda, counter) + 1)


def launch_bwd_prep(w: dict[str, torch.Tensor | None]) -> None:
    """The pre-pass on :func:`bwd_operands`: D = rowsum(dO * O) and L log2 e
    into the stats table, the dQ accumulator zeroed."""
    launch("flash_bwd_cuda", w["qs"].device, _library("flash_bwd_sm90").bvc_flash_bwd_prep,
           w["o"].data_ptr(), w["do"].data_ptr(), w["lse"].data_ptr(), w["stats"].data_ptr(),
           w["dq_acc"].data_ptr(), *_dims(w), *_strides(w["o"], w["do"]))
    _count(w, "launches_prep")


def launch_bwd_fused(w: dict[str, torch.Tensor | None]) -> None:
    """The five products: dK and dV written, dQs added into the
    accumulator (after :func:`launch_bwd_prep`)."""
    launch("flash_bwd_cuda", w["qs"].device, _library("flash_bwd_sm90").bvc_flash_bwd_sm90,
           *(w[x].data_ptr() for x in ("qs", "k", "v", "do", "stats")), _ptr(w["bias"]),
           *(w[x].data_ptr() for x in ("dk", "dv", "dq_acc")),
           *_dims(w), *_strides(*(w[x] for x in ("qs", "k", "v", "do", "dk", "dv"))))
    _count(w, "launches_fused")


def launch_bwd_post(w: dict[str, torch.Tensor | None]) -> None:
    """The post-pass: dQs as bf16 from the accumulator (after
    :func:`launch_bwd_fused`)."""
    launch("flash_bwd_cuda", w["qs"].device,
           _library("flash_bwd_sm90").bvc_flash_bwd_dq_store, w["dq_acc"].data_ptr(),
           w["dq"].data_ptr(), *_dims(w), *_strides(w["dq"]))
    _count(w, "launches_post")


def flash_bwd_cuda(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                   lse: torch.Tensor, do: torch.Tensor, bias: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three backward kernels of ``csrc/flash_bwd_sm90.cu`` on CUDA bf16
    ``[B, N, h, d]`` tensors and ``lse [B, h, N]`` f32, on the current
    stream; returns ``(dqs, dk, dv)`` like :func:`flash_attention_bwd_ref`.
    qs/k/v, O and dO are read through their strides, copied only where their
    layout needs it.  Raises on anything the kernels do not take, and if a
    launch fails.  Without a bias (d = 64) the launches count in
    ``.launches_prep``, ``.launches_fused`` and ``.launches_post``; with a
    key ``bias`` (d = 64 or 32) in ``.launches_prep_bias``,
    ``.launches_fused_bias`` and ``.launches_post_bias``."""
    w = bwd_operands(qs, k, v, o, lse, do, bias)
    if qs.numel() == 0:
        return w["dq"], w["dk"], w["dv"]
    launch_bwd_prep(w)
    launch_bwd_fused(w)
    launch_bwd_post(w)
    return w["dq"], w["dk"], w["dv"]


flash_bwd_cuda.launches_prep = 0
flash_bwd_cuda.launches_fused = 0
flash_bwd_cuda.launches_post = 0
flash_bwd_cuda.launches_prep_bias = 0
flash_bwd_cuda.launches_fused_bias = 0
flash_bwd_cuda.launches_post_bias = 0


def bwd_tile_check(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                   head_dim: int = HEAD_DIM) -> tuple[torch.Tensor, ...]:
    """The backward kernel's five products on one tile at ``head_dim`` (64
    or 32), on the card: ``qs``, ``do [64, d]``, ``k``, ``v [128, d]`` bf16
    in; ``(st, dpt, dv, dk, dq)`` f32 out with ``st = k qs^T``,
    ``dpt = v do^T`` (``[128, 64]``), ``dv = bf16(st) do``,
    ``dk = bf16(dpt) qs`` (``[128, d]``) and ``dq = bf16(dpt)^T k``
    (``[64, d]``), through the same TMA loads, shared-memory staging,
    swizzle and wgmma as the kernel.  A first check on a new card or
    toolkit, before anything runs on those products."""
    d = head_dim
    _check_tile_inputs("bwd_tile_check", d,
                       {"qs": (64, d), "k": (128, d), "v": (128, d), "do": (64, d)},
                       qs=qs, k=k, v=v, do=do)
    qs, k, v, do = (x.contiguous() for x in (qs, k, v, do))
    outs = [torch.empty(shape, dtype=torch.float32, device=qs.device)
            for shape in ((128, 64), (128, 64), (128, d), (128, d), (64, d))]
    launch("bwd_tile_check", qs.device, _library("flash_bwd_sm90").bvc_flash_bwd_tile_check,
           qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           *(x.data_ptr() for x in outs), d)
    return tuple(outs)


def _check_shapes(caller: str, bias: torch.Tensor | None, **tensors: torch.Tensor) -> None:
    """What the fakes check, from metadata alone: 4-D ``[B, N, h, d]``
    tensors of one shape and, if given, a ``[B, N]`` bias; for CUDA tensors
    also everything the kernels need (:func:`_check_kernel_inputs`)."""
    first = next(iter(tensors.values()))
    if first.is_cuda:
        _check_kernel_inputs(caller, bias, **tensors)
        return
    for name, x in tensors.items():
        if x.dim() != 4 or x.shape != first.shape:
            raise ValueError(f"{caller}: {', '.join(tensors)} must be 4-D tensors of one "
                             f"shape, got {name} {tuple(x.shape)}")
    if bias is not None and bias.shape != first.shape[:2]:
        raise ValueError(f"{caller}: bias of shape {tuple(bias.shape)}, want "
                         f"{tuple(first.shape[:2])}")


@torch.library.custom_op("bvc_tpu_torch::flash_fwd", mutates_args=(), device_types="cpu",
                         schema="(Tensor qs, Tensor k, Tensor v, Tensor? bias=None) -> "
                                "(Tensor, Tensor)")
def flash_fwd(qs, k, v, bias=None):
    """``(o, lse)``: :func:`flash_attention_fwd_ref` on CPU tensors (outputs
    contiguous, as the kernel writes them), :func:`flash_fwd_cuda` on CUDA
    ones."""
    return tuple(x.contiguous() for x in flash_attention_fwd_ref(qs, k, v, bias))


flash_fwd.register_kernel("cuda")(flash_fwd_cuda)


@flash_fwd.register_fake
def _flash_fwd_fake(qs, k, v, bias=None):
    _check_shapes("flash_fwd", bias, qs=qs, k=k, v=v)
    B, N, h, _ = qs.shape
    return qs.new_empty(qs.shape), qs.new_empty((B, h, N), dtype=torch.float32)


@torch.library.custom_op("bvc_tpu_torch::flash_bwd", mutates_args=(), device_types="cpu",
                         schema="(Tensor qs, Tensor k, Tensor v, Tensor o, Tensor lse, "
                                "Tensor do, Tensor? bias=None) -> (Tensor, Tensor, Tensor)")
def flash_bwd(qs, k, v, o, lse, do, bias=None):
    """``(dqs, dk, dv)``: :func:`flash_attention_bwd_ref` on CPU tensors
    (outputs contiguous), :func:`flash_bwd_cuda` on CUDA ones."""
    return tuple(x.contiguous() for x in flash_attention_bwd_ref(qs, k, v, o, lse, do, bias))


flash_bwd.register_kernel("cuda")(flash_bwd_cuda)


@flash_bwd.register_fake
def _flash_bwd_fake(qs, k, v, o, lse, do, bias=None):
    _check_shapes("flash_bwd", bias, qs=qs, k=k, v=v, o=o, do=do)
    B, N, h, _ = qs.shape
    if lse.shape != (B, h, N):
        raise ValueError(f"flash_bwd: lse of shape {tuple(lse.shape)}, want {(B, h, N)}")
    return qs.new_empty(qs.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _save_for_bwd(ctx, inputs, output) -> None:
    qs, k, v, bias = inputs
    o, lse = output
    ctx.save_for_backward(qs, k, v, o, lse, bias)
    ctx.mark_non_differentiable(lse)


def _flash_fwd_grad(ctx, do, _dlse):
    qs, k, v, o, lse, bias = ctx.saved_tensors
    return (*flash_bwd(qs, k, v, o, lse, do, bias), None)


flash_fwd.register_autograd(_flash_fwd_grad, setup_context=_save_for_bwd)


# the public names: the kernels for CUDA tensors, the plain versions for CPU
# tensors, differentiable in qs, k and v
flash_attention_fwd = flash_fwd
flash_attention_bwd = flash_bwd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None,
                    key_mask: torch.Tensor | None = None,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over ``[B, N, h, d]`` q/k/v, differentiable.

    The scale is folded into the queries outside the kernels, as the JAX
    package does: ``qs = (q * scale).to(q.dtype)``, so autograd carries it
    into dQ and dK gets none.  ``key_mask`` (``[B, N]`` bool, True =
    attendable) selects the key-bias kernels, as
    ``flash_attention(..., key_mask=)`` does in the JAX package; ``bias``
    is that mask's :func:`key_bias` already built (see
    :func:`resolve_bias`).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qs = (q * scale).to(q.dtype)
    bias = resolve_bias(key_mask, bias)
    if bias is not None:
        bias = bias.to(q.device, torch.float32).contiguous()
    return flash_attention_fwd(qs, k, v, bias)[0]
