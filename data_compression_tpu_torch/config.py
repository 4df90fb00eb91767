"""Codec configuration (jax-free copy of ``data_compression_tpu/config.py``).

The format fields, their defaults and their validation are the JAX
package's, so the same ``CodecConfig`` gives the same container bytes.
The TPU execution knobs (``use_pallas``, ``use_device``, ``use_scan``)
are gone: where the port runs is the ``device`` argument of each entry
point.
"""

from __future__ import annotations

import dataclasses

# Stable on-the-wire codec ids (framing.py writes these into the header).
CODEC_IDS = {
    "literal": 0,
    "nybble": 1,
    "small_byte": 2,
    "small_nybble": 3,
    "huffman": 4,
}
CODEC_NAMES = {v: k for k, v in CODEC_IDS.items()}

DEFAULT_BLOCK_SIZE = 64 * 1024
DEFAULT_CHUNK_SYMS = 512

# Huffman code lengths stay below 16 digits.
MAX_CODE_LEN = 15

MAX_ARITY = 64

# Huffman arities this package runs today; others raise NotImplementedError.
PORTED_ARITIES = (2,)


def _digits_per_byte(n: int) -> int:
    """Largest D with n**D <= 256: the wire packs D base-n digits per
    byte, little-endian."""
    d = 1
    while n ** (d + 1) <= 256:
        d += 1
    return d


def _arity_cap(n: int) -> int:
    """Length cap n^cap < 2^31, at most MAX_CODE_LEN.  The cap changes
    the tables and so the wire bytes: keep it even where 64-bit
    arithmetic is available."""
    cap = 1
    while n ** (cap + 1) < 2**31:
        cap += 1
    return min(cap, MAX_CODE_LEN)


ARITY_MAX_LEN = {n: _arity_cap(n) for n in range(2, MAX_ARITY + 1)}
ARITY_DIGITS_PER_BYTE = {n: _digits_per_byte(n) for n in range(2, MAX_ARITY + 1)}


def max_chunk_bytes(chunk_syms: int, arity: int) -> int:
    """Wire bytes of a chunk whose every symbol has the longest code
    (``data_compression_tpu/ops/huffman_coding.py:max_chunk_bytes``)."""
    d = ARITY_DIGITS_PER_BYTE[arity]
    return -(-(chunk_syms * ARITY_MAX_LEN[arity]) // d)


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Format configuration of a codec instance.

    Attributes:
      codec: codec family name (key of CODEC_IDS).
      arity: n for n-ary Huffman.
      block_size: uncompressed bytes per independent block.
      chunk_syms: symbols per intra-block chunk (Huffman parallel unit).
      shared_table: if True, one Huffman table for the whole stream; if
        False, a table per block.
    """

    codec: str = "huffman"
    arity: int = 2
    block_size: int = DEFAULT_BLOCK_SIZE
    chunk_syms: int = DEFAULT_CHUNK_SYMS
    shared_table: bool = False

    def __post_init__(self):
        if self.codec not in CODEC_IDS:
            raise ValueError(f"unknown codec {self.codec!r}")
        if self.codec == "huffman" and not 2 <= self.arity <= MAX_ARITY:
            raise ValueError(
                f"huffman arity must be in [2, {MAX_ARITY}], got {self.arity}"
            )
        if self.block_size <= 0 or self.block_size > 2**31:
            raise ValueError(f"bad block_size {self.block_size}")
        if self.chunk_syms <= 0 or self.block_size % self.chunk_syms:
            raise ValueError(
                f"chunk_syms {self.chunk_syms} must divide block_size {self.block_size}"
            )
        if self.codec == "huffman" and self.chunk_syms & (self.chunk_syms - 1):
            raise ValueError("huffman chunk_syms must be a power of two")

    @property
    def codec_id(self) -> int:
        return CODEC_IDS[self.codec]
