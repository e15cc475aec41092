"""prefill_mfu_pct.serve (%, model step): model FLOPs of every prompt
admitted in the window (costs.prefill_flops) over the summed wall of the
admission steps, over the bf16 peak."""

from portbench import readers


def read(rec):
    return readers.prefill_mfu_pct(rec)
