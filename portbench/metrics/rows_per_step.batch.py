"""rows_per_step.batch (rows, scheduler): live rows summed over the decode
steps of the window, over those steps (the counting namespace)."""

from portbench import readers


def read(rec):
    return readers.rows_per_step(rec)
