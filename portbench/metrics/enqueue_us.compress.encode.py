"""enqueue_us.compress.encode: mean host microseconds of the program's span
``device_api.compress.encode``, the stage ``encode`` of
``device_api.compress_blocks_device``: ``kencode.encode_blocks``, its
allocations and the encode kernel's launch.  Over the untraced calls among
the newest of the window, read from the program's call recorder."""

from portbench import spans


def read(run):
    return spans.stage_us(run, "compress", "device_api.compress", "encode")
