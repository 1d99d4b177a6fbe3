"""Training steps: host milliseconds a window step in the program's
``step.forward`` spans (summed over a step's microbatches where there are
several), inside the window's calls of the step."""

from portbench import program_spans


def read(view):
    return program_spans.step_ms(view, "step.forward")
