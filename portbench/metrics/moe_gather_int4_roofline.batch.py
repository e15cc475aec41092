"""moe_gather_int4_roofline.batch (%, kernels): K11b's share of its
roofline over the traced slice: the experts the traced steps' tokens
need (readers.moe_roofline)."""

from portbench import readers


def read(rec):
    return readers.moe_roofline(rec)
