"""compact_roofline: the compaction kernel (``ops/kernels/compact.py``,
``csrc/compact.cu``) against its roofline, in percent.  The stage reads
the payload (the chunks' wire bytes summed) and each block's byte count
once, and writes the payload once."""

from portbench import roofline

KERNEL = "compact_kernel"
COUNT = 4  # bytes of a block's payload count


def stage_bytes(s: dict) -> float:
    return 2 * s["payload_bytes"] + s["blocks"] * COUNT


def read(run):
    if run.stage.get("payload_bytes") is None:
        return None
    return roofline.kernel_share(run, KERNEL, stage_bytes(run.stage))
