"""pipeline_roofline.decompress: a whole ``decode_blocks_device`` call's
least time over its device time (the traced device operations' seconds
over the calls traced), in percent.  The least time moves the payload, the
wire length rows and the chunk index (offset, symbol count and block of
each chunk) read once and the raw bytes written once, at the HBM rate."""

from portbench import roofline

DRIVER = "decompress"
LENGTH_ROW = 256  # bytes: one code length a symbol
INDEX = 8 + 4 + 4  # bytes a chunk: its offset, symbol count and block


def stage_bytes(s: dict) -> float:
    return (s["payload_bytes"] + s["blocks"] * LENGTH_ROW + s["chunks"] * INDEX
            + s["raw_bytes"])


def read(run):
    if run.driver != DRIVER:
        return None
    return roofline.call_share(run, stage_bytes(run.stage))
