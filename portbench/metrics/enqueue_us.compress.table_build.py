"""enqueue_us.compress.table_build: mean host microseconds of the program's
span ``device_api.compress.table_build``, the stage ``table_build`` of
``device_api.compress_blocks_device``: ``build_tables``, its checks and the
table-build kernel's launch.  Over the untraced calls among the newest of
the window, read from the program's call recorder."""

from portbench import spans


def read(run):
    return spans.stage_us(run, "compress", "device_api.compress", "table_build")
