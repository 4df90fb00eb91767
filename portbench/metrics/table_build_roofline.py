"""table_build_roofline: the table-build kernel (``ops/kernels/table_build.py``
``build_tables``, ``csrc/table_build.cu``) against its roofline, in
percent.  The stage reads 256 counts a block and writes a block's wire
length row (a byte a symbol) and its code table (a code and its length in
4 bytes a symbol).  The merges are latency-bound work that no byte count
sees: this share is low by nature, and moves with that latency."""

from portbench import roofline

KERNEL = "table_build_kernel"
COUNT = 4  # bytes of a count
LENGTH = 1  # bytes of a wire code length
CODE = 4  # bytes of a code with its length (15 base-3 digits need 24 bits)


def stage_bytes(s: dict) -> float:
    return s["blocks"] * 256 * (COUNT + LENGTH + CODE)


def read(run):
    return roofline.kernel_share(run, KERNEL, stage_bytes(run.stage))
