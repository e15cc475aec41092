"""queue_wait_p95_s (s, scheduler): 95th percentile of due time to the step
in which the request left the batcher's waiting queue, every request due in
the window."""

from portbench import readers


def read(rec):
    return readers.queue_wait_s(rec)
