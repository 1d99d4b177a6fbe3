"""Tensor-core matrix products: a hand-written CUDA kernel and its plain
versions.

Counterpart of the probe kernels ``kern_i8`` (int8 x int8 -> int32) and
``kern_bf16`` (bf16 x bf16 -> f32) of ``tools/probe_pallas_int8.py``, and
of the int8 product inside :func:`bvc_tpu.ops.quant.qdense`.  Every
product here is ``C = A B^T`` with A ``[M, K]`` and B ``[N, K]``, both
K-contiguous: B is an ``nn.Linear`` weight (the probe's ``[K, N]`` B enters
transposed).  ``csrc/gemm.cu`` holds the kernel, one template instantiated
for int8 and for bf16.

- :func:`int8_matmul_cuda` ``(a, b)``: the exact int32 product (the raw
  epilogue, ``kern_i8``'s function); with ``xscale [M]`` and ``wscale
  [N]`` (and an optional ``bias [N]``, all f32) the dequant epilogue
  instead, qdense's tail ``(float(acc) * xscale[t]) * wscale[j] (+
  bias[j])`` in f32, written in ``out_dtype`` (bf16 or f32): the int32
  product never reaches device memory.
- :func:`bf16_matmul_cuda` ``(a, b)``: the f32 product (``kern_bf16``).

Both launch the kernel for CUDA tensors on the current stream, count their
launches in ``.launches`` and raise on anything the kernel does not take:
CPU tensors, other dtypes, K not a multiple of 16.  A row that does not
start on 16 bytes is copied into a fresh tensor first.
:func:`int8_matmul_ref` and :func:`bf16_matmul_ref` are the plain
versions: the CPU tests use them, and ``chip_smoke.py`` holds the kernel
against them on the card.  :func:`int8_matmul`, which ``qdense`` calls,
picks between the two by the tensors' device only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bvc_tpu_torch.ops._build import kernel_layout, launch, load_library

K_MULTIPLE = 16  # the kernel's K granularity, in elements
_OUT_KINDS = {torch.int32: 0, torch.bfloat16: 1, torch.float32: 2}  # bvc_gemm_s8's out_kind


def _dequant(acc: torch.Tensor, xscale: torch.Tensor, wscale: torch.Tensor,
             bias: torch.Tensor | None) -> torch.Tensor:
    """qdense's tail in f32, in its order: ``(acc * xscale) * wscale + bias``."""
    out = acc.float() * xscale[:, None] * wscale
    return out if bias is None else out + bias


def int8_matmul_ref(a: torch.Tensor, b: torch.Tensor, xscale: torch.Tensor | None = None,
                    wscale: torch.Tensor | None = None, bias: torch.Tensor | None = None,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of :func:`int8_matmul_cuda`: the int32 product
    ``a @ b.T`` of int8 ``a [M, K]`` and ``b [N, K]``, dequantized as the
    kernel does when ``xscale`` is given.  On the CPU an int32 product; on
    CUDA, which has no integer product, f64 cast back, which is exact:
    |sum| <= 128^2 K < 2^53."""
    if a.is_cuda:
        acc = (a.double() @ b.double().T).to(torch.int32)
    else:
        acc = a.int() @ b.int().T
    if xscale is None:
        return acc
    return _dequant(acc, xscale, wscale, bias).to(out_dtype)


def bf16_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`bf16_matmul_cuda`: ``a @ b.T`` in f32 (bf16
    products are exact in f32)."""
    return a.float() @ b.float().T


_SIGNATURES = {"bvc_gemm_s8": (6, 6), "bvc_gemm_bf16": (3, 5)}  # (void*, long long)


@functools.cache
def _library() -> ctypes.CDLL:
    """``csrc/gemm.cu``, built if needed, with its entry points typed."""
    return load_library("gemm", _SIGNATURES)


def _operand(caller: str, name: str, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as the kernel reads it: a 2-D CUDA tensor of ``dtype`` with
    contiguous rows that start on 16 bytes (copied into a fresh contiguous
    tensor where they do not)."""
    if not x.is_cuda or x.dtype != dtype or x.dim() != 2:
        raise ValueError(f"{caller}: {name} must be a 2-D CUDA {dtype} tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    return kernel_layout(x)


def _check_shapes(caller: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape[1] != b.shape[1] or a.device != b.device:
        raise ValueError(f"{caller}: a {tuple(a.shape)} on {a.device} and b "
                         f"{tuple(b.shape)} on {b.device} must share K and a device")
    if a.shape[1] % K_MULTIPLE:
        raise ValueError(f"{caller}: K = {a.shape[1]} is not a multiple of {K_MULTIPLE}")


def _vector(caller: str, name: str, x: torch.Tensor, length: int,
            device: torch.device) -> torch.Tensor:
    if x.device != device or x.dtype != torch.float32 or x.shape != (length,):
        raise ValueError(f"{caller}: {name} must be an f32 tensor of shape ({length},) on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    return x.contiguous()


def int8_matmul_cuda(a: torch.Tensor, b: torch.Tensor, xscale: torch.Tensor | None = None,
                     wscale: torch.Tensor | None = None, bias: torch.Tensor | None = None,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Launch the s8 kernel of ``csrc/gemm.cu`` on int8 ``a [M, K]`` and
    ``b [N, K]``: the int32 product without ``xscale``, else the dequant
    epilogue with f32 ``xscale [M]``, ``wscale [N]`` and optional ``bias
    [N]``, in ``out_dtype`` (bf16 or f32).  Counts launches in
    ``.launches``."""
    caller = "int8_matmul_cuda"
    a = _operand(caller, "a", a, torch.int8)
    b = _operand(caller, "b", b, torch.int8)
    _check_shapes(caller, a, b)
    (M, K), N = a.shape, b.shape[0]
    if xscale is None:
        if wscale is not None or bias is not None:
            raise ValueError(f"{caller}: wscale and bias need xscale")
        out_dtype = torch.int32
        ptrs = (None, None, None)
    else:
        if wscale is None or out_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"{caller}: the dequant epilogue takes xscale and wscale "
                             f"and writes bf16 or f32, not {out_dtype}")
        ptrs = (_vector(caller, "xscale", xscale, M, a.device).data_ptr(),
                _vector(caller, "wscale", wscale, N, a.device).data_ptr(),
                None if bias is None else _vector(caller, "bias", bias, N, a.device).data_ptr())
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if c.numel() == 0:
        return c
    launch(caller, a.device, _library().bvc_gemm_s8, a.data_ptr(), b.data_ptr(), *ptrs,
           c.data_ptr(), M, N, K, a.stride(0), b.stride(0), _OUT_KINDS[out_dtype])
    int8_matmul_cuda.launches += 1
    return c


int8_matmul_cuda.launches = 0


def bf16_matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the bf16 kernel of ``csrc/gemm.cu`` on bf16 ``a [M, K]`` and
    ``b [N, K]``: the f32 product ``a @ b.T``.  Counts launches in
    ``.launches``."""
    caller = "bf16_matmul_cuda"
    a = _operand(caller, "a", a, torch.bfloat16)
    b = _operand(caller, "b", b, torch.bfloat16)
    _check_shapes(caller, a, b)
    (M, K), N = a.shape, b.shape[0]
    c = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if c.numel() == 0:
        return c
    launch(caller, a.device, _library().bvc_gemm_bf16, a.data_ptr(), b.data_ptr(),
           c.data_ptr(), M, N, K, a.stride(0), b.stride(0))
    bf16_matmul_cuda.launches += 1
    return c


bf16_matmul_cuda.launches = 0


def _on_cpu(caller: str, a: torch.Tensor) -> bool:
    """True for CPU tensors, False for CUDA ones; raises for any other device."""
    if a.is_cuda:
        return False
    if a.device.type != "cpu":
        raise ValueError(f"{caller} runs on cuda or cpu, not {a.device}")
    return True


def int8_matmul(a: torch.Tensor, b: torch.Tensor, xscale: torch.Tensor | None = None,
                wscale: torch.Tensor | None = None, bias: torch.Tensor | None = None,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The s8 kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = int8_matmul_ref if _on_cpu("int8_matmul", a) else int8_matmul_cuda
    return fn(a, b, xscale, wscale, bias, out_dtype)
