"""enqueue_us.compress.histogram: mean host microseconds of the program's span
``device_api.compress.histogram``, the stage ``histogram`` of
``device_api.compress_blocks_device``: ``block_histograms``, its checks and
the histogram kernel's launch.  Over the untraced calls among the newest of
the window, read from the program's call recorder."""

from portbench import spans


def read(run):
    return spans.stage_us(run, "compress", "device_api.compress", "histogram")
