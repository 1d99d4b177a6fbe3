"""Models: device milliseconds a traced call of the kernels launched under
the program's ``bvc::gelu`` ranges, from the profile of the host's
operators (none without a device)."""


def read(view):
    trace = view.window.get("op_trace")
    device_us = 0.0 if trace is None else sum(us for _, us in trace.op_calls("bvc::gelu"))
    return device_us / 1e3 / trace.steps if device_us > 0 else None
