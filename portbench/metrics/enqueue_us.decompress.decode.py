"""enqueue_us.decompress.decode: mean host microseconds of the program's span
``device_api.decompress.decode``, the stage ``decode`` of
``device_api.decode_blocks_device``: the launcher's ``launch()``, the
output's allocation and the decode kernel's launch.  Over the untraced calls
among the newest of the window, read from the program's call recorder."""

from portbench import spans


def read(run):
    return spans.stage_us(run, "decompress", "device_api.decompress", "decode")
