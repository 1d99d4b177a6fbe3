"""Distributed runtime: rank 0's NCCL kernel time a window step that no
other kernel overlaps, milliseconds, from the traced window."""


def read(view):
    if view.trace is None or not any("nccl" in k[0].lower() for k in view.trace.kernels):
        return None
    return view.trace.nccl_exposed_us() / 1e3 / view.trace.steps
