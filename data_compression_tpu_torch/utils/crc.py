"""CRC32 integrity checks for framed blocks (copy of
``data_compression_tpu/utils/crc.py``)."""

from __future__ import annotations

import zlib

import numpy as np


def crc32(data) -> int:
    """CRC-32 (zlib polynomial) of bytes-like or uint8 ndarray."""
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data, dtype=np.uint8).tobytes()
    return zlib.crc32(data) & 0xFFFFFFFF


def crc32_blocks(blocks: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Per-row CRC32 of a [num_blocks, block_size] uint8 array;
    ``lengths[i]`` gives the valid prefix of row i."""
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    out = np.empty(blocks.shape[0], dtype=np.uint32)
    for i in range(blocks.shape[0]):
        out[i] = zlib.crc32(memoryview(blocks[i])[: int(lengths[i])])
    return out
