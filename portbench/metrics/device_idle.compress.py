"""device_idle.compress: percent of the traced window in which no operation
ran on the device (the profiler's trace)."""

from portbench import readers


def read(run):
    return readers.idle_pct(run, "compress")
