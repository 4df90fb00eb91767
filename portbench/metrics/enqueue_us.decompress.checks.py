"""enqueue_us.decompress.checks: mean host microseconds of the program's span
``device_api.decompress.checks``, the stage ``checks`` of
``device_api.decode_blocks_device``: the inputs' device checks.  Over the
untraced calls among the newest of the window, read from the program's call
recorder."""

from portbench import spans


def read(run):
    return spans.stage_us(run, "decompress", "device_api.decompress", "checks")
