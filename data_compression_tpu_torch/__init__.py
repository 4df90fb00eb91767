"""data_compression_tpu_torch — the codec family on PyTorch and CUDA.

The port of ``data_compression_tpu`` (JAX on a TPU, kept beside it as the
reference) to PyTorch with hand-written CUDA kernels for Hopper
(``sm_90a``).  Its containers are byte-identical to the reference's.
This package imports torch and never jax.

Ported so far: the n=2 canonical Huffman codec through ``compress`` /
``decompress`` / ``roundtrip`` and the CLI (``python -m
data_compression_tpu_torch``).  Every entry point takes ``device``
explicitly; on a CUDA device the encode, compaction and decode run in
the kernels under ``csrc/``, on the CPU in their plain PyTorch versions.
"""

from data_compression_tpu_torch.api import compress, decompress, roundtrip
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
    "roundtrip",
    "CodecConfig",
    "CODEC_IDS",
    "get_codec",
    "register_codec",
    "available_codecs",
    "__version__",
]
