"""The readings that a cell's limits are set from (run on the card, not by
the benchmark's own runs): the program's on many seeds, the control's (the
reference one precision below the configuration's), and the faults'."""
