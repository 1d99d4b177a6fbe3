"""Extraction entry: device idle milliseconds a traced call (the profile of
the device alone) in which the host was inside the program's ``extract.h2d``
span (the batch's copy to the device): each idle gap goes to the innermost
program span at its middle, the spans put on the device's clock by matching
``extract.call`` to the benchmark's ``call`` spans."""

from portbench import program_spans


def read(view):
    return program_spans.idle_ms(view, "extract.h2d")
