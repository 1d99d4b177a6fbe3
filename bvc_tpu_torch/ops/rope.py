"""3-D rotary position embeddings (RoPE) of attention queries and keys.

V-JEPA 2's encoder and predictor (Assran et al. 2025) carry no position
table: every attention rotates its queries and keys by each token's place in
the ``(T, H, W)`` token grid.  A head of width ``d`` splits into a time, a
row and a column segment of ``m = 2 * floor(floor(d / 3) / 2)`` channels each
(20 at d = 64, 10 at d = 32); the last ``d - 3m`` channels are not rotated.
Token id ``n`` sits at ``t = n // (H W)``, ``i = (n mod H W) // W``,
``j = n mod W``.  In the segment of axis ``a`` (offset ``s = 0, m, 2m``,
position ``p = t, i, j``) the pair of adjacent channels ``(s + 2k, s + 2k +
1)``, ``k < m / 2``, turns by ``theta = p * 10000^(-2k / m)``::

    (x0, x1) -> (x0 cos theta - x1 sin theta,  x1 cos theta + x0 sin theta)

Nothing of the JAX package has it: this module adds the operator, and
``csrc/rope.cu`` its kernels.  The rotated channel pairs are numbered ``0 ..
P - 1`` (``P = 3m / 2``): pair ``p`` is channels ``2p`` and ``2p + 1``.

- :func:`rope_tables`: ``cos`` and ``sin`` ``[T H W, P]`` f32 of every token
  id of a grid, worked out once per (grid, head width, device) in float64 on
  the CPU, rounded to f32 and kept;
- :func:`rope_rotate`: the eager chain over ``[B, N, h, d]`` at positions
  ``pos [B, N]`` (int32 token ids in the grid, from :func:`rope_positions`):
  f32 products and sums, each rounded on its own, then the input dtype;
- the operators ``torch.ops.bvc_tpu_torch.rope3d(q, k, cos, sin, pos) ->
  (q', k')`` (:data:`rope3d_op`) and its gradient ``.rope3d_bwd(dq', dk',
  cos, sin, pos) -> (dq, dk)`` (:data:`rope3d_bwd_op`), the rotation by
  ``-theta``; nothing is saved for it but the tables and the positions.  On
  CUDA tensors they launch ``csrc/rope.cu``'s two kernels, which read q and
  k through their strides (the ``[B, N, 3, h, d]`` view of the fused qkv
  product goes in without a copy) and write contiguous outputs, and which
  make the eager chain's multiplies and adds in its order, so that they
  give it bit for bit; :func:`rope3d_cuda` counts their launches in
  ``.launches`` and ``.launches_bwd``.  On CPU tensors they run the eager
  chain (the backward: the chain with ``-sin``, bit for bit autograd's
  gradient through it);
- :func:`rope3d`: what the blocks call, inside a ``bvc::rope`` range (the
  backward opens one too): the operator for bf16, the eager chain for any
  other dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bvc_tpu_torch.ops._build import launch, load_library
from bvc_tpu_torch.utils.profiling import profiler_range

ROPE_BASE = 10000.0


def rope_segment(head_dim: int) -> int:
    """``m``: the channels of each axis's segment of a head."""
    return 2 * ((head_dim // 3) // 2)


def rope_pairs(head_dim: int) -> int:
    """``P = 3m / 2``: the rotated channel pairs of a head."""
    return 3 * rope_segment(head_dim) // 2


@functools.lru_cache(maxsize=None)
def rope_tables(grid: tuple[int, int, int], head_dim: int,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)``, each ``[T H W, P]`` f32 on ``device``: the angle of
    rotated pair ``p`` of every token id of the ``(T, H, W)`` grid, in
    float64 on the CPU, then rounded to f32 once.  Kept per argument."""
    T, H, W = grid
    m = rope_segment(head_dim)
    if m == 0:
        raise ValueError(f"rope3d: head width {head_dim} leaves no channels to rotate")
    ids = torch.arange(T * H * W, dtype=torch.int64)
    axes = (ids // (H * W), (ids % (H * W)) // W, ids % W)
    inv = ROPE_BASE ** (-torch.arange(0, m, 2, dtype=torch.float64) / m)
    angle = torch.cat([a.double()[:, None] * inv[None, :] for a in axes], dim=1)
    return (angle.cos().float().contiguous().to(device),
            angle.sin().float().contiguous().to(device))


def rope_positions(idx: torch.Tensor) -> torch.Tensor:
    """Token ids ``[B, N]`` as the operator takes them: int32, contiguous,
    a ``-1`` pad read as position 0 (its key is masked)."""
    return idx.clamp(min=0).to(torch.int32).contiguous()


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """The eager chain: ``x [B, N, h, d]`` with its first ``2P`` channels
    turned pair by pair by the angles of ``pos [B, N]`` (rows of ``cos`` and
    ``sin`` ``[G, P]``), in f32 (f64 for f64 ``x``); the rest passed
    through; ``x``'s dtype out.  ``rope_rotate(dy, cos, -sin, pos)`` is the
    gradient."""
    P = cos.shape[1]
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    c, s = cos[pos].unsqueeze(2), sin[pos].unsqueeze(2)
    x0, x1 = xf[..., 0:2 * P:2], xf[..., 1:2 * P:2]
    y = torch.stack((x0 * c - x1 * s, x1 * c + x0 * s), dim=-1).flatten(-2)
    return torch.cat((y, xf[..., 2 * P:]), dim=-1).to(x.dtype)


# the library in csrc/ that each custom operator's CUDA side launches
OP_LIBRARIES = {"rope3d": "rope", "rope3d_bwd": "rope"}
_SIGNATURES = {"bvc_rope3d_fwd": (7, 9), "bvc_rope3d_bwd": (7, 9)}


@functools.cache
def _library() -> ctypes.CDLL:
    """``csrc/rope.cu``, built if needed, with its entry points typed."""
    return load_library("rope", _SIGNATURES)


def _check_shapes(caller: str, x: torch.Tensor, y: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, pos: torch.Tensor) -> None:
    """What the fakes check from metadata alone, and the kernels need on
    CUDA tensors: ``x`` and ``y`` 4-D ``[B, N, h, d]`` of one shape,
    ``cos``/``sin`` ``[G, P]`` f32 with ``P`` the head's rotated pairs,
    ``pos`` ``[B, N]`` int32; on CUDA also bf16 on one device, d a multiple
    of 8, and the tables and positions contiguous."""
    if x.dim() != 4 or x.shape != y.shape:
        raise ValueError(f"{caller}: inputs must be 4-D [B, N, h, d] tensors of one shape, "
                         f"got {tuple(x.shape)} and {tuple(y.shape)}")
    B, N, _, d = x.shape
    P = rope_pairs(d)
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dim() != 2 or t.shape[1] != P or t.dtype != torch.float32:
            raise ValueError(f"{caller}: {name} must be an f32 [G, {P}] table, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if pos.shape != (B, N) or pos.dtype != torch.int32:
        raise ValueError(f"{caller}: pos must be int32 of shape {(B, N)}, got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    if not x.is_cuda:
        return
    if any(t.device != x.device for t in (y, cos, sin, pos)):
        raise ValueError(f"{caller}: every tensor must be on {x.device}")
    if x.dtype != torch.bfloat16 or y.dtype != torch.bfloat16 or d % 8:
        raise ValueError(f"{caller}: the kernels take bf16 heads of a width that divides by "
                         f"8, got {x.dtype} / {y.dtype} at d = {d}")
    if not all(t.is_contiguous() for t in (cos, sin, pos)):
        raise ValueError(f"{caller}: cos, sin and pos must be contiguous")


def _row_layout(x: torch.Tensor) -> torch.Tensor:
    """``x [B, N, h, d]`` as the kernels read it: each token's ``h d``
    values one run on the 16-byte grid at ``b * stride(0) + n * stride(1)``;
    else a fresh contiguous copy."""
    B, N, h, d = x.shape
    ok = (x.stride(3) == 1 and x.stride(2) == d and x.data_ptr() % 16 == 0
          and x.stride(0) % 8 == 0 and x.stride(1) % 8 == 0)
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def _launch(entry: str, x: torch.Tensor, y: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor, pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    x, y = _row_layout(x), _row_layout(y)
    B, N, h, d = x.shape
    ox = torch.empty((B, N, h, d), dtype=x.dtype, device=x.device)
    oy = torch.empty((B, N, h, d), dtype=y.dtype, device=y.device)
    if x.numel() == 0:
        return ox, oy
    launch("rope3d_cuda", x.device, getattr(_library(), entry), x.data_ptr(), y.data_ptr(),
           cos.data_ptr(), sin.data_ptr(), pos.data_ptr(), ox.data_ptr(), oy.data_ptr(),
           B, N, h, d, cos.shape[1], x.stride(0), x.stride(1), y.stride(0), y.stride(1))
    return ox, oy


def rope3d_cuda(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/rope.cu``'s forward on CUDA bf16 ``q`` and ``k`` on the
    current stream; returns :func:`rope_rotate` of each, contiguous, bit for
    bit.  Raises on anything the kernel does not take and if the launch
    fails; launches nothing for empty tensors.  Counts launches in
    ``.launches``."""
    _check_shapes("rope3d_cuda", q, k, cos, sin, pos)
    out = _launch("bvc_rope3d_fwd", q, k, cos, sin, pos)
    if q.numel():
        rope3d_cuda.launches += 1
    return out


def rope3d_bwd_cuda(dq: torch.Tensor, dk: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                    pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/rope.cu``'s backward (the rotation by ``-theta``) on
    CUDA bf16 gradients of the rotated q and k; returns ``rope_rotate(.,
    cos, -sin, pos)`` of each, contiguous.  Counts launches in
    ``rope3d_cuda.launches_bwd``."""
    _check_shapes("rope3d_bwd_cuda", dq, dk, cos, sin, pos)
    out = _launch("bvc_rope3d_bwd", dq, dk, cos, sin, pos)
    if dq.numel():
        rope3d_cuda.launches_bwd += 1
    return out


rope3d_cuda.launches = 0
rope3d_cuda.launches_bwd = 0


@torch.library.custom_op("bvc_tpu_torch::rope3d", mutates_args=(), device_types="cpu",
                         schema="(Tensor q, Tensor k, Tensor cos, Tensor sin, Tensor pos) -> "
                                "(Tensor, Tensor)")
def rope3d_op(q, k, cos, sin, pos):
    """``(q', k')``: :func:`rope_rotate` on CPU tensors (contiguous, as the
    kernel writes them), :func:`rope3d_cuda` on CUDA ones."""
    _check_shapes("rope3d", q, k, cos, sin, pos)
    return (rope_rotate(q, cos, sin, pos).contiguous(),
            rope_rotate(k, cos, sin, pos).contiguous())


rope3d_op.register_kernel("cuda")(rope3d_cuda)


@torch.library.custom_op("bvc_tpu_torch::rope3d_bwd", mutates_args=(), device_types="cpu",
                         schema="(Tensor dq, Tensor dk, Tensor cos, Tensor sin, Tensor pos) -> "
                                "(Tensor, Tensor)")
def rope3d_bwd_op(dq, dk, cos, sin, pos):
    """``(dq, dk)`` of :data:`rope3d_op`: :func:`rope_rotate` with ``-sin``
    on CPU tensors, :func:`rope3d_bwd_cuda` on CUDA ones."""
    _check_shapes("rope3d_bwd", dq, dk, cos, sin, pos)
    return (rope_rotate(dq, cos, -sin, pos).contiguous(),
            rope_rotate(dk, cos, -sin, pos).contiguous())


rope3d_bwd_op.register_kernel("cuda")(rope3d_bwd_cuda)


def _fake(caller: str):
    def fake(x, y, cos, sin, pos):
        _check_shapes(caller, x, y, cos, sin, pos)
        return (torch.empty_like(x, memory_format=torch.contiguous_format),
                torch.empty_like(y, memory_format=torch.contiguous_format))

    return fake


rope3d_op.register_fake(_fake("rope3d"))
rope3d_bwd_op.register_fake(_fake("rope3d_bwd"))


def _save_angles(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs[2:])


def _rope3d_grad(ctx, gq, gk):
    cos, sin, pos = ctx.saved_tensors
    gq = torch.zeros_like(gk) if gq is None else gq
    gk = torch.zeros_like(gq) if gk is None else gk
    with profiler_range("rope"):
        dq, dk = rope3d_bwd_op(gq, gk, cos, sin, pos)
    return dq, dk, None, None, None


rope3d_op.register_autograd(_rope3d_grad, setup_context=_save_angles)


def rope3d(q: torch.Tensor, k: torch.Tensor, pos: torch.Tensor,
           grid: tuple[int, int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """``q`` and ``k`` ``[B, N, h, d]`` rotated at the token ids ``pos [B,
    N]`` (int32, :func:`rope_positions`) of ``grid``: :data:`rope3d_op` for
    bf16, the eager chain otherwise; differentiable.  A ``bvc::rope`` range
    while a profiler records."""
    with profiler_range("rope"):
        cos, sin = rope_tables(tuple(grid), q.shape[-1], q.device)
        if q.dtype == torch.bfloat16:
            return rope3d_op(q, k, cos, sin, pos)
        return rope_rotate(q, cos, sin, pos), rope_rotate(k, cos, sin, pos)
