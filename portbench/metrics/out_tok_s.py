"""out_tok_s (tokens/s): every output token of the steps that started in
the window, over the window's seconds, its edges moved to the ends of the
steps that straddle them (readers.step_window)."""

from portbench import readers


def read(rec):
    st, seconds = readers.step_window(rec)
    return sum(s["tokens"] for s in st) / seconds
