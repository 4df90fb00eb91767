"""data_compression_tpu_torch — the codec family on PyTorch and CUDA.

The port of ``data_compression_tpu`` (JAX on a TPU, kept beside it as the
reference) to PyTorch with hand-written CUDA kernels for Hopper
(``sm_90a``).  Its containers are byte-identical to the reference's.
This package imports torch and never jax.

Ported so far: all five codecs through ``compress`` / ``decompress`` /
``roundtrip``, the streaming and file drivers, the printable container
and the CLI (``python -m data_compression_tpu_torch``), the
device-resident pipeline (``device_api``),
the sharded pipeline on ``torch.distributed`` (``parallel``, Huffman
only as in the reference), the native C runtime (``native``) and the
profiling tools (``tools``).  Every entry point takes ``device``
explicitly.  The n-ary canonical Huffman codec builds its code lengths
in the native runtime; at arities 2, 3 and 16 on a CUDA device its
encode, compaction and decode run in the kernels under ``csrc/``, on the
CPU in their plain PyTorch versions, and every other arity runs the
pure-Python host path on any device, as in the reference.  The serial
codecs ``nybble``, ``small_byte`` and ``small_nybble`` run, on a CUDA
device, in the serial lanes (``ops/scan_codecs.py``, one CUDA thread or
warp per block, kernels under ``csrc/``), and on the CPU in the native
runtime's OpenMP batch drivers, the JAX package's production route;
``literal`` is a host pass-through.  Made for ``cuda``, every codec
raises where no CUDA device is present.
"""

from data_compression_tpu_torch.api import (
    compress,
    compress_file,
    decompress,
    decompress_file,
    roundtrip,
)
from data_compression_tpu_torch.config import CODEC_IDS, CodecConfig
from data_compression_tpu_torch.registry import (
    available_codecs,
    get_codec,
    register_codec,
)

__version__ = "0.1.0"

__all__ = [
    "compress",
    "decompress",
    "compress_file",
    "decompress_file",
    "roundtrip",
    "CodecConfig",
    "CODEC_IDS",
    "get_codec",
    "register_codec",
    "available_codecs",
    "__version__",
]
