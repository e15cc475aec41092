"""device_idle_pct.serve (%, device): 100 - the union of device-activity
intervals over the traced slice, in percent of the slice."""

from portbench import readers


def read(rec):
    return readers.device_idle_pct(rec)
