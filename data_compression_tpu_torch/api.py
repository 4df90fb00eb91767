"""High-level compress / decompress API (counterpart of
``data_compression_tpu/api.py``).

Split into blocks -> encode the blocks on ``device`` -> universal
LITERAL fallback -> frame; and the inverse with per-block CRC checks.
Every entry point takes the device explicitly; nothing picks one.  The
serial codecs run on the host whatever the device (``models/base.py``
``HostCodec``).  Streaming and file drivers are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from data_compression_tpu_torch import framing
from data_compression_tpu_torch.config import CodecConfig
from data_compression_tpu_torch.models.base import EncodeResult
from data_compression_tpu_torch.registry import get_codec
from data_compression_tpu_torch.utils.crc import crc32, crc32_blocks

BytesLike = Union[bytes, bytearray, memoryview, np.ndarray]

STATS_CODECS = ("nybble", "small_byte", "small_nybble")


def _as_bytes(data: BytesLike) -> bytes:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, dtype=np.uint8).tobytes()
    return bytes(data)


def compress(
    data: BytesLike,
    config: Optional[CodecConfig] = None,
    meta: Optional[bytes] = None,
    device="cuda",
    stats=None,
) -> bytes:
    """Compress a byte stream into a framed container on ``device``.

    ``meta`` attaches an annotation block that decoders skip (raw_len 0,
    CRC of the annotation bytes themselves).

    ``stats``: optional ``utils.debug.CodecStats`` collecting per-context
    prediction/dictionary hit counters during encode (the reference's
    times_used_directly, nybble_compression.c:543).  Supported by the
    serial codecs (STATS_CODECS); collection routes their encode
    through the host path (byte-identical payloads)."""
    config = config or CodecConfig()
    raw = _as_bytes(data)
    blocks, lengths = framing.split_blocks(raw, config.block_size)
    codec = get_codec(config, device)
    if stats is not None:
        if config.codec not in STATS_CODECS:
            raise ValueError(
                f"stats collection supports codecs {STATS_CODECS}, "
                f"not {config.codec!r}"
            )
        result = codec.encode_blocks(blocks, lengths, stats=stats)
    else:
        result = codec.encode_blocks(blocks, lengths)
    return pack_blocks(config, len(raw), blocks, lengths, result, meta)


def pack_blocks(config: CodecConfig, total_len: int, blocks: np.ndarray,
                lengths: np.ndarray, result: EncodeResult,
                meta: Optional[bytes] = None) -> bytes:
    """Frame encoded blocks: per-block CRC32, the universal LITERAL
    fallback, the optional meta block and the container header."""
    payloads, flags, crcs = [], [], []
    raw_lens = []
    if meta is not None:
        payloads.append(bytes(meta))
        flags.append(framing.BLOCK_META)
        crcs.append(crc32(bytes(meta)))
        raw_lens.append(0)
    block_crcs = crc32_blocks(blocks, lengths)
    for i, payload in enumerate(result.payloads):
        raw_len = int(lengths[i])
        crcs.append(int(block_crcs[i]))
        # Universal LITERAL fallback: store raw when compression loses.
        if len(payload) >= raw_len and config.codec != "literal":
            payloads.append(blocks[i, :raw_len].tobytes())
            flags.append(framing.BLOCK_LITERAL)
        else:
            payloads.append(payload)
            flags.append(0)
        raw_lens.append(raw_len)

    chunk_log2 = (
        config.chunk_syms.bit_length() - 1 if config.codec == "huffman" else 0
    )
    return framing.pack_frame(
        codec_id=config.codec_id,
        arity=config.arity,
        block_size=config.block_size,
        total_len=total_len,
        payloads=payloads,
        raw_lens=raw_lens,
        crcs=crcs,
        block_flags=flags,
        shared_table=result.shared_table,
        chunk_log2=chunk_log2,
    )


def decompress(data: BytesLike, device="cuda") -> bytes:
    """Decompress one binary framed container on ``device``.  The format
    parameters come from the frame.  A serial-codec frame stores no chunk
    size and its codec reads none, so its config takes ``chunk_syms =
    block_size``: the original's 4096 fails validation for every block
    size above 4096 that 4096 does not divide."""
    raw = _as_bytes(data)
    frame = framing.unpack_frame(raw)
    if frame.codec_name == "huffman":
        chunk_syms = frame.chunk_syms or min(4096, frame.block_size)
    else:
        chunk_syms = frame.block_size
    cfg = CodecConfig(
        codec=frame.codec_name,
        arity=frame.arity if frame.codec_name == "huffman" else 2,
        block_size=frame.block_size,
        chunk_syms=chunk_syms,
        shared_table=frame.shared_table is not None,
    )
    codec = get_codec(cfg, device)

    coded_idx = [
        i for i, e in enumerate(frame.entries)
        if not e.is_literal and not e.is_meta
    ]
    out: list = [None] * len(frame.entries)
    for i, e in enumerate(frame.entries):
        if e.is_meta:
            if crc32(frame.payloads[i]) != e.crc:
                raise ValueError(f"block {i}: meta CRC mismatch")
            out[i] = b""
        elif e.is_literal:
            out[i] = frame.payloads[i]
    if coded_idx:
        decoded = codec.decode_blocks(
            [frame.payloads[i] for i in coded_idx],
            [frame.entries[i].raw_len for i in coded_idx],
            shared_table=frame.shared_table,
        )
        for i, blk in zip(coded_idx, decoded):
            out[i] = blk

    for i, e in enumerate(frame.entries):
        if e.is_meta:
            continue
        if len(out[i]) != e.raw_len:
            raise ValueError(f"block {i}: decoded length {len(out[i])} != {e.raw_len}")
        if crc32(out[i]) != e.crc:
            raise ValueError(f"block {i}: CRC mismatch (corrupt stream?)")
    result = b"".join(out)
    if len(result) != frame.total_len:
        raise ValueError("total length mismatch")
    return result


def roundtrip(data: BytesLike, config: Optional[CodecConfig] = None,
              device="cuda") -> bool:
    """compress -> decompress -> compare."""
    return decompress(compress(data, config, device=device), device=device) == _as_bytes(data)
