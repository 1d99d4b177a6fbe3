"""Operators and kernels: device milliseconds a traced training step of the
kernels launched under the program's ``bvc::mask_unit_attn`` ranges (the
query pool, the window permutes and the attention of Hiera's mask-unit
blocks, forward and backward), from the profile of the host's operators
(none where the program has no such range)."""


def read(view):
    trace = view.window.get("op_trace")
    if trace is None:
        return None
    device_us = sum(us for _, us in trace.op_calls("bvc::mask_unit_attn"))
    return device_us / 1e3 / trace.steps if device_us > 0 else None
