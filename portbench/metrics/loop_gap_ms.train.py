"""Trainer loop: mean host milliseconds a window step between one step's
return and the next step's call (the loader's wait, the lag-1 metric read,
the CSV row), from the benchmark's spans around each call."""

from portbench import readers


def read(view):
    return readers.gap_ms(view)
