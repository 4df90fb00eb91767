"""compress_GBps: raw bytes of every compress call done in the window over
the window's seconds, in GB/s (1e9 bytes), host clock."""

from portbench import readers


def read(run):
    return readers.rate_GBps(run, "compress")
