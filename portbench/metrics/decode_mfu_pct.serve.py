"""decode_mfu_pct.serve (%, model step): model FLOPs of the window's decode
quanta (costs.decode_flops over their live row-steps and K/V slots) over
the wall of the steps that ran only a quantum, over the bf16 peak."""

from portbench import readers


def read(rec):
    return readers.decode_mfu_pct(rec)
