"""High-level compress / decompress API (counterpart of
``data_compression_tpu/api.py``).

Split into blocks -> encode the blocks on ``device`` -> universal
LITERAL fallback -> frame; and the inverse with per-block CRC checks.
Every entry point takes the device explicitly; nothing picks one.  The
serial codecs made for ``cuda`` run in the serial lanes
(``ops/scan_codecs.py``, CUDA kernels), made for ``cpu`` in the native
batch drivers; ``literal`` is a host pass-through on either
(``models/base.py`` ``HostCodec``).  The streaming and file drivers hold at most one batch
of blocks resident and write one independent frame per batch, as the
JAX package's do (its CLI's ``compress`` always streams).
"""

from __future__ import annotations

import os
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
    printable: bool = False,
) -> bytes:
    """Compress a byte stream into a framed container on ``device``.

    ``meta`` attaches an annotation block that decoders skip (raw_len 0,
    CRC of the annotation bytes themselves).

    ``printable=True`` armors the frame as the in-band printable
    container (``framing.frame_to_printable``): every block payload an
    independent Z85 span, the whole stream printable text.

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
    frame = pack_blocks(config, len(raw), blocks, lengths, result, meta)
    return framing.frame_to_printable(frame) if printable else frame


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
    """Decompress one framed container, binary or printable (detected by
    its magic), on ``device``.  The format parameters come from the
    frame.  A serial-codec frame stores no chunk size and its codec reads
    none, so its config takes ``chunk_syms = block_size``: the original's
    4096 fails validation for every block size above 4096 that 4096 does
    not divide."""
    raw = _as_bytes(data)
    if raw.startswith(framing.PRINTABLE_MAGIC):
        raw = framing.printable_to_frame(raw)
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


# ----------------------------------------------------------------------
# Streaming and file drivers: bounded memory over unbounded inputs
# ----------------------------------------------------------------------

DEFAULT_BATCH_BLOCKS = 256  # 16 MiB resident per batch at 64 KiB blocks


def compress_stream(
    fin,
    fout,
    config: Optional[CodecConfig] = None,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
    printable: bool = False,
    stats=None,
    device="cuda",
) -> dict:
    """Compress a binary stream into a concatenation of independent
    frames, one per ``batch_blocks * block_size`` bytes read, holding at
    most one batch of input resident; an empty input gives one empty
    frame.  ``printable=True`` armors each frame on its own, so an
    unbounded input streams to printable text."""
    config = config or CodecConfig()
    batch_bytes = batch_blocks * config.block_size
    total_in = 0
    total_out = 0
    frames = 0
    while True:
        chunk = fin.read(batch_bytes)
        if not chunk:
            break
        out = compress(chunk, config, device=device, stats=stats, printable=printable)
        fout.write(out)
        total_in += len(chunk)
        total_out += len(out)
        frames += 1
    if frames == 0:  # empty input still yields one valid (empty) frame
        out = compress(b"", config, device=device, stats=stats, printable=printable)
        fout.write(out)
        total_out += len(out)
        frames = 1
    return {
        "raw_bytes": total_in,
        "compressed_bytes": total_out,
        "frames": frames,
        "ratio": total_out / max(1, total_in),
    }


def decompress_stream(fin, fout, device="cuda") -> dict:
    """Inverse of compress_stream: frames (binary or printable, mixed)
    are read and decoded one at a time, so at most one frame is
    resident.  A stream with no frame raises ValueError."""
    total_in = 0
    total_out = 0
    frames = 0
    while True:
        frame_bytes = framing.read_frame(fin)
        if frame_bytes is None:
            break
        out = decompress(frame_bytes, device=device)
        fout.write(out)
        total_in += len(frame_bytes)
        total_out += len(out)
        frames += 1
    if frames == 0:
        raise ValueError("empty input: no frames")
    return {
        "compressed_bytes": total_in,
        "raw_bytes": total_out,
        "frames": frames,
    }


def compress_file(
    src: str,
    dst: str,
    config: Optional[CodecConfig] = None,
    streaming: Optional[bool] = None,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
    device="cuda",
) -> dict:
    """File driver.  ``streaming=None`` streams files larger than one
    batch; a smaller file gives the single frame of ``compress``."""
    config = config or CodecConfig()
    if streaming is None:
        streaming = os.path.getsize(src) > batch_blocks * config.block_size
    with open(src, "rb") as f:
        if streaming:
            with open(dst, "wb") as g:
                return compress_stream(f, g, config, batch_blocks, device=device)
        data = f.read()
    out = compress(data, config, device=device)
    with open(dst, "wb") as f:
        f.write(out)
    return {
        "raw_bytes": len(data),
        "compressed_bytes": len(out),
        "ratio": len(out) / max(1, len(data)),
    }


def decompress_file(src: str, dst: str, device="cuda") -> dict:
    """File driver; always frame by frame (a single-frame container is
    the one-iteration case)."""
    with open(src, "rb") as f, open(dst, "wb") as g:
        return decompress_stream(f, g, device)
