"""The chip's peaks and the shares of them that the metric readers report.

NVIDIA H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM3 at the full
700 W power limit.  A stage's least time is its bytes, each input byte
read once and each output byte written once, at that rate; its share of
the roofline is that least time over the time it took on the device.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def kernel_share(run, kernel: str, nbytes: float):
    """Percent of the roofline of the traced kernels whose short name holds
    ``kernel``, moving ``nbytes`` a launch; None when the trace has none."""
    if run.trace is None:
        return None
    seconds, count = 0.0, 0
    for name, (sec, n) in run.trace.ops.items():
        if kernel in name:
            seconds += sec
            count += n
    if not count or seconds <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / (seconds / count)


def call_share(run, nbytes: float):
    """Percent of the roofline of a whole call: its least time over its
    device time, the traced device operations' seconds over the calls
    traced; None without a trace."""
    if run.trace is None or not run.traced_calls or run.trace.device_s <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / (run.trace.device_s / run.traced_calls)
