"""Operators and kernels: the traced extraction window's calls of
``bvc_tpu_torch::flash_fwd``, frozen least time over device time, percent."""

from portbench import readers


def read(view):
    return readers.attention_roofline(view, readers.FLASH_FWD)
