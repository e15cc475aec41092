"""mfu_pct.batch (%, model step): model FLOPs of every token processed in the
window, prompts admitted and decode row-steps (a MoE token counts k of E
experts), over the window's seconds (readers.step_window), over the bf16
peak."""

from portbench import readers


def read(rec):
    return readers.window_mfu_pct(rec)
