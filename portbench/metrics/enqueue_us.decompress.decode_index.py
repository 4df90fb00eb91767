"""enqueue_us.decompress.decode_index: mean host microseconds of the program's
span ``device_api.decompress.decode_index``, the stage ``decode_index`` of
``device_api.decode_blocks_device``: ``kdecode.decode_launcher``: its
checks, the ``searchsorted`` and the ``arange``.  Over the untraced calls
among the newest of the window, read from the program's call recorder."""

from portbench import spans


def read(run):
    return spans.stage_us(run, "decompress", "device_api.decompress", "decode_index")
