"""Operators and kernels: the traced training window's calls of
``bvc_tpu_torch::flash_fwd``, the sum of their frozen least times over the
device time of the kernels under them, in percent."""

from portbench import readers


def read(view):
    return readers.attention_roofline(view, readers.FLASH_FWD)
