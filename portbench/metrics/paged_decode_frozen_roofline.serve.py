"""paged_decode_frozen_roofline.serve (%, kernels): K8's share of its
roofline over the traced slice (readers.paged_decode_roofline)."""

from portbench import readers


def read(rec):
    return readers.paged_decode_roofline(rec)
