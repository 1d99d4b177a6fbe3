"""The 3-D RoPE operator (``bvc_tpu_torch/ops/rope.py``) on CPU tensors:
its eager chain against the equations written out on their own
(``tests/reference_vjepa2.py``'s ``rope``) at head widths 64 and 32, with the
unrotated tail and ``-1`` pads; the bf16 operator bit for bit the eager
chain, its backward bit for bit autograd's gradient through the chain (the
CUDA kernels make the same operations in the same order; ``chip_smoke.py``
holds them to it on the card); ``gradcheck`` of the backward in float64;
fakes and schemas (``opcheck``); the routing by dtype inside ``bvc::rope``.

Tolerances: the eager chain against the equations, 1e-6 absolute (the same
f32 products; the angles' float64 powers may round differently in their
last bit); everything else exact.
"""

import pytest
import torch

from bvc_tpu_torch.ops import rope as rope_mod
from bvc_tpu_torch.ops.rope import (rope3d, rope3d_bwd_op, rope3d_op, rope_pairs,
                                    rope_positions, rope_rotate, rope_segment, rope_tables)
from reference_vjepa2 import rope as reference_rope

GRID = (4, 3, 5)


def _inputs(d: int, dtype=torch.float32, heads: int = 3, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    B, N = 2, 17
    x = torch.randn(B, N, heads, d, generator=gen).to(dtype)
    ids = torch.randint(-1, GRID[0] * GRID[1] * GRID[2], (B, N), generator=gen)
    ids[0, :3] = torch.tensor([-1, 0, GRID[0] * GRID[1] * GRID[2] - 1])
    return x, ids


def _bits(x):
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x.view(torch.int32)


@pytest.mark.parametrize("d,m,pairs", [(64, 20, 30), (32, 10, 15), (88, 28, 42)])
def test_segments(d, m, pairs):
    assert rope_segment(d) == m and rope_pairs(d) == pairs


@pytest.mark.parametrize("d", [64, 32])
def test_eager_chain_is_the_equations(d):
    x, ids = _inputs(d)
    cos, sin = rope_tables(GRID, d, torch.device("cpu"))
    assert cos.shape == sin.shape == (GRID[0] * GRID[1] * GRID[2], rope_pairs(d))
    got = rope_rotate(x, cos, sin, rope_positions(ids))
    want = reference_rope(x, ids, GRID)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    tail = 3 * rope_segment(d)
    assert torch.equal(got[..., tail:], x[..., tail:])  # the unrotated channels
    # a -1 pad sits at position 0: unrotated, as token 0 is
    torch.testing.assert_close(got[0, 0], x[0, 0], rtol=0, atol=0)
    assert not torch.equal(got[0, 2], x[0, 2])


@pytest.mark.parametrize("d", [64, 32])
def test_bf16_operator_is_the_eager_chain_bit_for_bit(d):
    x, ids = _inputs(d, torch.bfloat16)
    y, _ = _inputs(d, torch.bfloat16, seed=1)
    pos = rope_positions(ids)
    cos, sin = rope_tables(GRID, d, torch.device("cpu"))
    qr, kr = rope3d_op(x, y, cos, sin, pos)
    assert qr.is_contiguous() and qr.dtype == torch.bfloat16
    assert torch.equal(_bits(qr), _bits(rope_rotate(x, cos, sin, pos)))
    assert torch.equal(_bits(kr), _bits(rope_rotate(y, cos, sin, pos)))
    # strided views, as the fused qkv product gives them
    qkv = torch.stack([x, y, x], dim=2)
    q2, k2 = rope3d_op(qkv[:, :, 0], qkv[:, :, 1], cos, sin, pos)
    assert torch.equal(_bits(q2), _bits(qr)) and torch.equal(_bits(k2), _bits(kr))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 32])
def test_backward_is_autograds_through_the_chain(d, dtype):
    x, ids = _inputs(d, dtype)
    y, _ = _inputs(d, dtype, seed=1)
    gq, gk = (_inputs(d, dtype, seed=s)[0] for s in (2, 3))
    pos = rope_positions(ids)
    cos, sin = rope_tables(GRID, d, torch.device("cpu"))
    xr, yr = x.clone().requires_grad_(), y.clone().requires_grad_()
    torch.autograd.backward([rope_rotate(xr, cos, sin, pos), rope_rotate(yr, cos, sin, pos)],
                            [gq, gk])
    dq, dk = rope3d_bwd_op(gq, gk, cos, sin, pos)
    assert torch.equal(_bits(dq + 0), _bits(xr.grad + 0))
    assert torch.equal(_bits(dk + 0), _bits(yr.grad + 0))
    xo, yo = x.clone().requires_grad_(), y.clone().requires_grad_()
    torch.autograd.backward(list(rope3d_op(xo, yo, cos, sin, pos)), [gq, gk])
    assert torch.equal(_bits(xo.grad), _bits(dq)) and torch.equal(_bits(yo.grad), _bits(dk))


def test_gradcheck():
    x, ids = _inputs(32, torch.float64)
    y, _ = _inputs(32, torch.float64, seed=1)
    cos, sin = rope_tables(GRID, 32, torch.device("cpu"))
    pos = rope_positions(ids[:, :4])
    assert torch.autograd.gradcheck(
        lambda a, b: rope3d_op(a, b, cos, sin, pos),
        (x[:, :4].clone().requires_grad_(), y[:, :4].clone().requires_grad_()))


def test_opcheck():
    x, ids = _inputs(64, torch.bfloat16)
    y, _ = _inputs(64, torch.bfloat16, seed=1)
    cos, sin = rope_tables(GRID, 64, torch.device("cpu"))
    pos = rope_positions(ids)
    torch.library.opcheck(rope3d_op, (x.clone().requires_grad_(), y.clone(), cos, sin, pos))
    torch.library.opcheck(rope3d_bwd_op, (x, y, cos, sin, pos))


def test_refusals():
    x, ids = _inputs(64, torch.bfloat16)
    cos, sin = rope_tables(GRID, 64, torch.device("cpu"))
    with pytest.raises(ValueError, match="pos must be int32"):
        rope3d_op(x, x, cos, sin, ids)
    with pytest.raises(ValueError, match="table"):
        rope3d_op(x, x, cos[:, :-1], sin, rope_positions(ids))
    with pytest.raises(ValueError, match="one shape"):
        rope3d_op(x, x[:, :-1], cos, sin, rope_positions(ids))
    with pytest.raises(ValueError, match="no channels"):
        rope_tables(GRID, 4, torch.device("cpu"))


@pytest.mark.parametrize("dtype,op_calls", [(torch.bfloat16, 1), (torch.float32, 0)])
def test_routing_by_dtype_inside_the_range(dtype, op_calls):
    x, ids = _inputs(64, dtype)
    pos = rope_positions(ids)
    xr = x.clone().requires_grad_()
    with torch.profiler.profile() as prof:
        q, k = rope3d(xr, x, pos, GRID)
        (q.float().sum() + k.float().sum()).backward()
    names = [e.name for e in prof.events()]
    assert names.count("bvc_tpu_torch::rope3d") == op_calls
    assert names.count("bvc_tpu_torch::rope3d_bwd") == op_calls
    assert names.count("bvc::rope") == 1 + op_calls  # the backward opens its own
    cos, sin = rope_tables(GRID, 64, torch.device("cpu"))
    assert torch.equal(_bits(q), _bits(rope_rotate(x, cos, sin, pos)))


@pytest.mark.parametrize("op", ["rope3d", "rope3d_bwd"])
def test_cuda_kernel_registered(op):
    name = f"bvc_tpu_torch::{op}"
    for key in ("CPU", "CUDA", "Meta"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key), (op, key)


def test_kernel_entry_points_are_typed():
    assert rope_mod._SIGNATURES == {"bvc_rope3d_fwd": (7, 9), "bvc_rope3d_bwd": (7, 9)}
    src = (rope_mod.__file__.rsplit("/", 2)[0] + "/csrc/rope.cu")
    text = open(src).read()
    for entry in rope_mod._SIGNATURES:
        assert f'extern "C" int {entry}(' in text
    assert rope_mod.OP_LIBRARIES == {"rope3d": "rope", "rope3d_bwd": "rope"}
