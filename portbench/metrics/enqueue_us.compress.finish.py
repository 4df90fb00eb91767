"""enqueue_us.compress.finish: mean host microseconds of the program's span
``device_api.compress.finish``, the stage ``finish`` of
``device_api.compress_blocks_device``: ``wire_bytes``, the payload total,
the length rows' cast and the handle, up to the return.  Over the untraced
calls among the newest of the window, read from the program's call recorder."""

from portbench import spans


def read(run):
    return spans.stage_us(run, "compress", "device_api.compress", "finish")
