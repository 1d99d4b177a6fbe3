"""Data: host milliseconds a window step that the trainer's loop waited for
its next batch, from the program's ``loader.wait`` spans between two of the
window's calls (over the gaps between calls, as ``loop_gap_ms.train``)."""

from portbench import program_spans


def read(view):
    return program_spans.gap_ms(view, "loader.wait")
