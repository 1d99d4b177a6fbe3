"""Operators and kernels: device milliseconds a traced training step of the
kernels launched under the program's ``bvc::rope`` ranges (forward and
backward), from the profile of the host's operators (none where the
program has no such range)."""


def read(view):
    trace = view.window.get("op_trace")
    device_us = 0.0 if trace is None else sum(us for _, us in trace.op_calls("bvc::rope"))
    return device_us / 1e3 / trace.steps if device_us > 0 else None
