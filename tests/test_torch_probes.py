"""The softmax-dtype probe's plain forward against the probe's own Pallas
kernel (``tools/probe_softmax_dtype.py::_fwd_kernel``) in interpret mode,
with the grid and block specs of its ``fwd`` and both score dtypes, and the
plain ``xla_attn`` against the probe's.

Tolerance: one bf16 ulp of the reference per entry (outputs are bf16; the
f32 sums run in another order, and exp differs by f32 ulps, which can move
a bf16 rounding by one step).  The kernel divides by l after the P V
product while ``xla_attn`` normalises P first: the two differ by 3.9e-3 at
``[1, 2, 128, 64]``, so each is held against its own counterpart.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bvc_tpu_torch.probes import int8_dot, softmax_dtype
from bvc_tpu_torch.probes.softmax_dtype import (softmax_probe_fwd_cuda, softmax_probe_fwd_ref,
                                                xla_attn)

TOOL = Path(__file__).resolve().parent.parent / "tools" / "probe_softmax_dtype.py"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tool():
    spec = importlib.util.spec_from_file_location("probe_softmax_dtype", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _interpret_fwd(tool, q, k, v, bq, score_dtype):
    """The probe's ``fwd`` (tools/probe_softmax_dtype.py:57-70) with
    ``interpret=True``."""
    B, h, N, d = q.shape
    kernel = lambda *refs: tool._fwd_kernel(*refs, score_dtype=score_dtype)  # noqa: E731
    return pl.pallas_call(
        kernel,
        grid=(B, h, N // bq),
        in_specs=[
            pl.BlockSpec((1, 1, bq, d), lambda b, hh, i: (b, hh, i, 0)),
            pl.BlockSpec((1, 1, N, d), lambda b, hh, i: (b, hh, 0, 0)),
            pl.BlockSpec((1, 1, N, d), lambda b, hh, i: (b, hh, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, 1, bq, d), lambda b, hh, i: (b, hh, i, 0)),
        out_shape=jax.ShapeDtypeStruct((B, h, N, d), q.dtype),
        interpret=True,
    )(q, k, v)


def _inputs(shape, seed):
    """The probe's inputs: q ~ N(0, 1) x 0.125, k, v ~ N(0, 1), in bf16."""
    rng = np.random.default_rng(seed)
    arrays = [(rng.standard_normal(shape) * s).astype(np.float32) for s in (0.125, 1, 1)]
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    tx = [torch.from_numpy(a).bfloat16() for a in arrays]
    return jx, tx


def _within_one_ulp(ours: torch.Tensor, ref) -> float:
    """Max error in units of the reference's bf16 spacing; asserts <= 1."""
    ref = np.asarray(ref, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), np.finfo(np.float32).tiny))) - 7)
    err = np.abs(ours.float().numpy() - ref) / ulp
    assert err.max() <= 1.0, err.max()
    return float(err.max())


@pytest.mark.parametrize("score", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 2, 128, 64), (2, 2, 192, 64)])
def test_plain_forward_matches_the_probe_kernel(shape, score):
    jdt, tdt = DTYPES[score]
    (qj, kj, vj), (qt, kt, vt) = _inputs(shape, seed=shape[2])
    ref = _interpret_fwd(_tool(), qj, kj, vj, 64, jdt)
    ours = softmax_probe_fwd_ref(qt, kt, vt, tdt)
    assert ours.dtype == torch.bfloat16 and ours.shape == shape
    # read: at most 1 ulp, on 0.02% (f32 scores) and 3% (bf16 scores) of entries
    _within_one_ulp(ours, ref)


@pytest.mark.parametrize("score", ["f32", "bf16"])
def test_xla_attn_matches_the_probe(score):
    jdt, tdt = DTYPES[score]
    (qj, kj, vj), (qt, kt, vt) = _inputs((2, 2, 130, 64), seed=3)
    ref = _tool().xla_attn(qj, kj, vj, jdt)
    # read: 0 ulp at both score dtypes
    _within_one_ulp(xla_attn(qt, kt, vt, tdt), ref)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    _, (q, k, v) = _inputs((1, 1, 16, 64), seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        softmax_probe_fwd_cuda(q, k, v)
    with pytest.raises(ValueError, match="score_dtype"):
        softmax_probe_fwd_ref(q, k, v, torch.float16)


@pytest.mark.parametrize("probe", [int8_dot, softmax_dtype], ids=["int8_dot", "softmax_dtype"])
def test_probes_need_a_card(probe, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.run()
