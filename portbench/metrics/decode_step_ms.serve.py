"""decode_step_ms.serve (ms, model step): wall of the window's step() calls
that ran only a decode quantum, over their decode steps."""

from portbench import readers


def read(rec):
    return readers.decode_step_ms(rec)
