"""enqueue_us.compress.compact: mean host microseconds of the program's span
``device_api.compress.compact``, the stage ``compact`` of
``device_api.compress_blocks_device``: ``_compact_into``, the block offsets'
``cumsum`` and the compaction kernel's launch.  Over the untraced calls
among the newest of the window, read from the program's call recorder."""

from portbench import spans


def read(run):
    return spans.stage_us(run, "compress", "device_api.compress", "compact")
