"""pipeline_roofline.compress: a whole ``compress_blocks_device`` call's
least time over its device time (the traced device operations' seconds
over the calls traced), in percent.  The least time moves the raw bytes
read once, and the payload, the wire length rows and the chunks' wire
byte counts written once, at the HBM rate."""

from portbench import roofline

DRIVER = "compress"
LENGTH_ROW = 256  # bytes: one code length a symbol
COUNT = 4  # bytes of a chunk's wire byte count


def stage_bytes(s: dict) -> float:
    return (s["raw_bytes"] + s["payload_bytes"] + s["blocks"] * LENGTH_ROW
            + s["chunks"] * COUNT)


def read(run):
    if run.driver != DRIVER or run.stage.get("payload_bytes") is None:
        return None
    return roofline.call_share(run, stage_bytes(run.stage))
