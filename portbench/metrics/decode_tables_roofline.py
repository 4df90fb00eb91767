"""decode_tables_roofline: the decode-table kernel (``ops/kernels/table_build.py``
``decode_tables``, ``csrc/decode_tables.cu``) against its roofline, in
percent.  The stage reads each block's wire length row once and writes its
decode tables once: the symbols in code order (a byte each) and, for each
length 0..L, a limit and a rank base (4 bytes each)."""

from portbench import roofline

KERNEL = "decode_tables_kernel"
WORD = 4


def stage_bytes(s: dict) -> float:
    L = s["code_digits"]
    return s["blocks"] * (256 + 256 + 2 * (L + 1) * WORD)


def read(run):
    return roofline.kernel_share(run, KERNEL, stage_bytes(run.stage))
