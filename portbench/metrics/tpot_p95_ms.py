"""tpot_p95_ms (ms): 95th percentile over the requests that finished in the
window of (last token - first token) / (tokens - 1)."""

from portbench import readers


def read(rec):
    return readers.tpot_ms(rec)
