"""Training steps: device idle milliseconds a traced step (the profile of
the device alone) in which the trainer's thread was inside the program's
``step.update`` span: each idle gap goes to the innermost program span at its
middle, the spans put on the device's clock by matching ``trainer.step`` to
the benchmark's ``step`` spans (``portbench/program_spans.py``)."""

from portbench import program_spans


def read(view):
    return program_spans.idle_ms(view, "step.update")
