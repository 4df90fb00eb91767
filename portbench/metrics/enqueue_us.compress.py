"""enqueue_us.compress: mean host microseconds from entering
``device_api.compress_blocks_device`` to its return, over the untraced
calls of the window (the host clock around each call)."""

from portbench import readers


def read(run):
    return readers.enqueue_us(run, "compress")
