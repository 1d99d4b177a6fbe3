"""Training steps: mean host milliseconds from a call of the step that the
trainer's factory returned to its return, over the window's steps."""

from portbench import readers


def read(view):
    return readers.call_ms(view)
