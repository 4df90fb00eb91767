"""enqueue_us.decompress.decode_tables: mean host microseconds of the program's
span ``device_api.decompress.decode_tables``, the stage ``decode_tables`` of
``device_api.decode_blocks_device``: ``decode_tables``, its checks and the
decode-table kernel's launch.  Over the untraced calls among the newest of
the window, read from the program's call recorder."""

from portbench import spans


def read(run):
    return spans.stage_us(run, "decompress", "device_api.decompress", "decode_tables")
