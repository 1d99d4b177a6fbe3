"""Operators and kernels: the traced training window's calls of
``bvc_tpu_torch::flash_fwd`` and ``::flash_bwd`` at head width 32 without a
key bias (Hiera's decoder), the sum of their frozen least times
(``portbench/arith_hiera.py``: ``arith``'s attention bounds at d = 32) over
the device time of the kernels under them, in percent (none where the
program makes no such call)."""

from portbench import arith_hiera, readers

BOUNDS = {readers.FLASH_FWD: (arith_hiera.flash32_fwd_bound_ms, 3),
          readers.FLASH_BWD: (arith_hiera.flash32_bwd_bound_ms, 6)}


def read(view):
    trace = view.window.get("op_trace")
    if trace is None:
        return None
    bound_ms = device_us = 0.0
    for op, (bound, bias_at) in BOUNDS.items():
        for shapes, dev_us in trace.op_calls(op):
            B, N, h, d = shapes[0]
            if d != 32 or (len(shapes) > bias_at and shapes[bias_at]):
                continue
            bound_ms += bound(B, N, h)
            device_us += dev_us
    return 100.0 * bound_ms * 1e3 / device_us if device_us > 0 else None
