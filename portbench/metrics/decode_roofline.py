"""decode_roofline: the decode kernel (``ops/kernels/decode.py``,
``csrc/huffman_decode.cu``) against its roofline, in percent.  The stage
reads the payload, the chunk index (offset, symbol count and block of
each chunk) and each block's decode tables once, and writes the raw bytes
once."""

from portbench import roofline

KERNEL = "huffman_decode_kernel"
INDEX = 8 + 4 + 4  # bytes a chunk
WORD = 4


def stage_bytes(s: dict) -> float:
    L = s["code_digits"]
    tables = s["blocks"] * (256 + 2 * (L + 1) * WORD)
    return s["payload_bytes"] + s["chunks"] * INDEX + tables + s["raw_bytes"]


def read(run):
    return roofline.kernel_share(run, KERNEL, stage_bytes(run.stage))
