"""enqueue_us.compress.checks: mean host microseconds of the program's span
``device_api.compress.checks``, the stage ``checks`` of
``device_api.compress_blocks_device``: the configuration, device and shape
checks, the raw lengths and the capacity, from the entry up to the
histogram.  Over the untraced calls among the newest of the window, read
from the program's call recorder."""

from portbench import spans


def read(run):
    return spans.stage_us(run, "compress", "device_api.compress", "checks")
