"""ttft_p95_s (s): 95th percentile of first-token time minus due time over
every request due in the window (readers.ttft_s)."""

from portbench import readers


def read(rec):
    return readers.ttft_s(rec)
