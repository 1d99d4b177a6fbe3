"""The int8 dot probe: counterpart of ``tools/probe_pallas_int8.py``.

Does an int8 x int8 -> int32 product inside a hand-written kernel run
exactly, and at what rate against the same kernel in bf16?  The probe's
two kernels are the instantiations of ``csrc/gemm.cu``
(:func:`~bvc_tpu_torch.ops.gemm.int8_matmul_cuda` for ``kern_i8``,
:func:`~bvc_tpu_torch.ops.gemm.bf16_matmul_cuda` for ``kern_bf16``).  The
TPU probe's B is ``[K, N]``; the kernel takes ``[N, K]``, so B enters
transposed.

Run on the card::

    python -m bvc_tpu_torch.probes.int8_dot

checks the int8 kernel against the exact product at 1024^3, then times both
kernels at ``[8192, 1024] x [1024, 1024]`` on the probe's integer-valued
inputs (in [-127, 126]) and prints their ratio as one JSON line.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from bvc_tpu_torch.ops.gemm import bf16_matmul_cuda, int8_matmul_cuda, int8_matmul_ref
from bvc_tpu_torch.utils.device import cuda_time_ms, resolve_device

EXACT_SHAPE = (1024, 1024, 1024)  # M, K, N
RATE_SHAPE = (8192, 1024, 1024)


def probe_operands(m: int, k: int, n: int, rng: np.random.Generator,
                   device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe's int8 operands, A ``[M, K]`` and B as ``[N, K]``, with
    entries in [-127, 126] as ``rng.integers(-127, 127)`` draws them."""
    a = torch.from_numpy(rng.integers(-127, 127, (m, k), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 127, (k, n), dtype=np.int8))
    return a.to(device), b.T.contiguous().to(device)


def run() -> dict:
    """The probe's readings on the card."""
    device = resolve_device()
    rng = np.random.default_rng(0)
    a, b = probe_operands(*EXACT_SHAPE, rng, device)
    exact = torch.equal(int8_matmul_cuda(a, b), int8_matmul_ref(a, b))
    a, b = probe_operands(*RATE_SHAPE, rng, device)
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    t8 = cuda_time_ms(lambda: int8_matmul_cuda(a, b))
    t16 = cuda_time_ms(lambda: bf16_matmul_cuda(a16, b16))
    return {"exact_1024": exact, "shape": list(RATE_SHAPE), "int8_ms": t8, "bf16_ms": t16,
            "bf16_over_int8": t16 / t8}


def main() -> None:
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
