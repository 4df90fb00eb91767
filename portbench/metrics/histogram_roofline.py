"""histogram_roofline: the histogram kernel (``ops/kernels/histogram.py``,
``csrc/histogram.cu``) against its roofline, in percent: the stage's least
time over the kernel's mean device time a launch in the trace.  The stage
reads the valid raw bytes once and writes 256 counts a block."""

from portbench import roofline

KERNEL = "histogram_kernel"
COUNT = 4  # bytes of a count (a 64 KiB block's counts need 17 bits)


def stage_bytes(s: dict) -> float:
    return s["raw_bytes"] + s["blocks"] * 256 * COUNT


def read(run):
    return roofline.kernel_share(run, KERNEL, stage_bytes(run.stage))
