"""Operators and kernels: the traced training window's calls of
``bvc_tpu_torch::flash_bwd`` (five products, three outputs), the sum of
their frozen least times over their kernels' device time, in percent."""

from portbench import readers


def read(view):
    return readers.attention_roofline(view, readers.FLASH_BWD)
