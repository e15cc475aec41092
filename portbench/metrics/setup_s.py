"""setup_s (s): process start to the window's start, less the lead-in: weights
made on the card, the system built, the cell's shapes warmed."""


def read(rec):
    return rec.setup_s
