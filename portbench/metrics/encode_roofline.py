"""encode_roofline: the compact encode kernel (``ops/kernels/encode.py``,
``csrc/huffman_encode.cu``) against its roofline, in percent.  The stage
reads the valid raw bytes and each block's code table once and writes the
payload (the chunks' wire bytes summed, not the rows' capacity) and each
chunk's count once."""

from portbench import roofline

KERNEL = "huffman_encode_kernel"
CODE = 4  # bytes of a code with its length
COUNT = 4  # bytes of a chunk's digit count


def stage_bytes(s: dict) -> float:
    return s["raw_bytes"] + s["blocks"] * 256 * CODE + s["payload_bytes"] + s["chunks"] * COUNT


def read(run):
    if run.stage.get("payload_bytes") is None:
        return None
    return roofline.kernel_share(run, KERNEL, stage_bytes(run.stage))
