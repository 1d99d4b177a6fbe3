"""Operators and kernels: the traced training window's calls of
``bvc_tpu_torch::rope3d`` and ``::rope3d_bwd``, the sum of their frozen
least times (``portbench/arith_rope.py``: q and k read and written in bf16,
the positions and tables once, at 3.35 TB/s) over the device time of the
kernels under them, in percent (none where the program has no such
operator)."""

from portbench import arith_rope

OPS = ("bvc_tpu_torch::rope3d", "bvc_tpu_torch::rope3d_bwd")


def read(view):
    trace = view.window.get("op_trace")
    if trace is None:
        return None
    bound_ms = device_us = 0.0
    for op in OPS:
        for shapes, dev_us in trace.op_calls(op):
            B, N, h, d = shapes[0]
            grid_tokens, pairs = shapes[2]
            bound_ms += arith_rope.rope_bound_ms(B, N, h, d, grid_tokens, pairs)
            device_us += dev_us
    return 100.0 * bound_ms * 1e3 / device_us if device_us > 0 else None
