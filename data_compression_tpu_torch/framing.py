"""Binary container format (v1), copied from
``data_compression_tpu/framing.py`` so the port writes and reads the
same bytes.

Layout (all little-endian):

  +--------------------------------------------------------------+
  | magic "DCTZ" | ver u16 | flags u16 | codec u8 | arity u8 |   |
  | bsize u32 | nblocks u32 | total u64 | chunk_log2 u16 |header |
  | crc u32                                        = 32 bytes    |
  +--------------------------------------------------------------+
  | optional shared-table section: len u32 + payload (flag bit0) |
  +--------------------------------------------------------------+
  | block table: nblocks x {comp u32, raw u32, crc u32,          |
  |                         bflags u32}             16 B/entry   |
  +--------------------------------------------------------------+
  | payload_0 | payload_1 | ...                                  |
  +--------------------------------------------------------------+

Block flag bit0 = LITERAL pass-through (payload is the raw bytes), bit1 =
META annotation block.  CRC32 is of the uncompressed block.

The in-band printable container (``PRINTABLE_MAGIC``) armors the header,
the metadata region and every block payload as independent Z85 spans
whose lengths follow from the (armored) block table, so the stream is
printable text and every block stays locatable.  ``read_frame`` detects
it per frame and returns the binary equivalent; the port's two checks
of ``unpack_frame`` / ``read_frame`` (an unknown codec id and a cut
block table raise ValueError) hold on the printable path too.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from data_compression_tpu_torch.config import CODEC_NAMES
from data_compression_tpu_torch.utils.base64url import z85_core, z85_core_decode, z85_core_len
from data_compression_tpu_torch.utils.crc import crc32

MAGIC = b"DCTZ"
VERSION = 1

FLAG_SHARED_TABLE = 1 << 0

BLOCK_LITERAL = 1 << 0
BLOCK_META = 1 << 1

PRINTABLE_MAGIC = b"DCTP1\n"

_HEADER = struct.Struct("<4sHHBBIIQHI")  # 32 bytes
_ENTRY = struct.Struct("<IIII")  # 16 bytes
assert _HEADER.size == 32
assert _ENTRY.size == 16


@dataclasses.dataclass
class BlockEntry:
    comp_len: int
    raw_len: int
    crc: int
    flags: int

    @property
    def is_literal(self) -> bool:
        return bool(self.flags & BLOCK_LITERAL)

    @property
    def is_meta(self) -> bool:
        return bool(self.flags & BLOCK_META)


@dataclasses.dataclass
class Frame:
    codec_id: int
    arity: int
    block_size: int
    total_len: int
    flags: int
    shared_table: Optional[bytes]
    entries: List[BlockEntry]
    payloads: List[bytes]
    chunk_log2: int = 0  # log2(chunk_syms) for chunked codecs; 0 = n/a

    @property
    def codec_name(self) -> str:
        return CODEC_NAMES[self.codec_id]

    @property
    def chunk_syms(self) -> int:
        return 1 << self.chunk_log2 if self.chunk_log2 else 0


def _check_codec(codec_id: int) -> None:
    if codec_id not in CODEC_NAMES:
        raise ValueError(f"unknown codec id {codec_id}")


def pack_frame(
    codec_id: int,
    arity: int,
    block_size: int,
    total_len: int,
    payloads: Sequence[bytes],
    raw_lens: Sequence[int],
    crcs: Sequence[int],
    block_flags: Sequence[int],
    shared_table: Optional[bytes] = None,
    chunk_log2: int = 0,
) -> bytes:
    """Assemble a complete framed stream."""
    n = len(payloads)
    if not n == len(raw_lens) == len(crcs) == len(block_flags):
        raise ValueError("pack_frame: per-block sequences differ in length")
    flags = FLAG_SHARED_TABLE if shared_table is not None else 0
    head_wo_crc = _HEADER.pack(
        MAGIC, VERSION, flags, codec_id, arity, block_size, n, total_len,
        chunk_log2, 0
    )[:-4]
    header = head_wo_crc + struct.pack("<I", crc32(head_wo_crc))
    parts = [header]
    if shared_table is not None:
        parts.append(struct.pack("<I", len(shared_table)))
        parts.append(shared_table)
    for p, r, c, f in zip(payloads, raw_lens, crcs, block_flags):
        parts.append(_ENTRY.pack(len(p), int(r), int(c) & 0xFFFFFFFF, int(f)))
    parts.extend(payloads)
    return b"".join(parts)


def unpack_frame(data: bytes) -> Frame:
    """Parse a binary framed stream; every structural fault raises
    ValueError (a printable container: bad magic)."""
    if len(data) < _HEADER.size:
        raise ValueError("truncated frame: header")
    (magic, ver, flags, codec_id, arity, bsize, nblocks, total, chunk_log2, hcrc) = (
        _HEADER.unpack_from(data, 0)
    )
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic!r}")
    if ver != VERSION:
        raise ValueError(f"unsupported version {ver}")
    if crc32(data[: _HEADER.size - 4]) != hcrc:
        raise ValueError("header CRC mismatch")
    _check_codec(codec_id)
    off = _HEADER.size
    shared_table = None
    if flags & FLAG_SHARED_TABLE:
        if len(data) < off + 4:
            raise ValueError("truncated frame: shared table length")
        (tlen,) = struct.unpack_from("<I", data, off)
        off += 4
        shared_table = bytes(data[off : off + tlen])
        if len(shared_table) != tlen:
            raise ValueError("truncated frame: shared table")
        off += tlen
    if len(data) < off + nblocks * _ENTRY.size:
        raise ValueError("truncated frame: block table")
    entries = []
    for k in range(nblocks):
        comp, raw, bcrc, bflags = _ENTRY.unpack_from(data, off)
        off += _ENTRY.size
        # split_blocks never writes a longer block; the header CRC does not
        # cover the table, and a decoder sizes its output by this length
        if raw > bsize:
            raise ValueError(f"block {k}: raw length {raw} exceeds the block size {bsize}")
        entries.append(BlockEntry(comp, raw, bcrc, bflags))
    payloads = []
    mv = memoryview(data)
    for e in entries:
        payloads.append(bytes(mv[off : off + e.comp_len]))
        if len(payloads[-1]) != e.comp_len:
            raise ValueError("truncated frame: payload")
        off += e.comp_len
    return Frame(
        codec_id=codec_id,
        arity=arity,
        block_size=bsize,
        total_len=total,
        flags=flags,
        shared_table=shared_table,
        entries=entries,
        payloads=payloads,
        chunk_log2=chunk_log2,
    )


def frame_to_printable(frame: bytes) -> bytes:
    """Binary frame -> all-isprint container (Z85 spans + newlines)."""
    f = unpack_frame(frame)  # validates header CRC + structure
    head = frame[: _HEADER.size]
    off = _HEADER.size
    meta_len = 0
    if f.flags & FLAG_SHARED_TABLE:
        meta_len += 4 + len(f.shared_table)
    meta_len += len(f.entries) * _ENTRY.size
    meta = frame[off : off + meta_len]
    parts = [
        PRINTABLE_MAGIC.decode(),
        z85_core(head),
        "\n",
        z85_core(meta),
        "\n",
    ]
    parts.extend(z85_core(p) for p in f.payloads)
    parts.append("\n")
    return "".join(parts).encode("ascii")


def _printable_header(head: bytes) -> Tuple[int, int]:
    """Check a printable container's decoded header; -> (flags, nblocks)."""
    (magic, ver, flags, codec_id, _a, _b, nblocks, _t, _cl, hcrc) = _HEADER.unpack(head)
    if magic != MAGIC or ver != VERSION:
        raise ValueError("bad printable header")
    if crc32(head[:-4]) != hcrc:
        raise ValueError("header CRC mismatch")
    _check_codec(codec_id)
    return flags, nblocks


def _comp_lens(meta: bytes, nblocks: int) -> List[int]:
    """Payload byte counts of the block table at the end of ``meta``."""
    base = len(meta) - nblocks * _ENTRY.size
    return [_ENTRY.unpack_from(meta, base + k * _ENTRY.size)[0] for k in range(nblocks)]


def printable_to_frame(data: bytes) -> bytes:
    """Inverse of frame_to_printable -> the exact binary frame bytes."""
    if not data.startswith(PRINTABLE_MAGIC):
        raise ValueError("not a printable container")
    text = data[len(PRINTABLE_MAGIC) :].decode("ascii", errors="strict")
    hl = z85_core_len(_HEADER.size)
    if len(text) < hl + 1 or text[hl] != "\n":
        raise ValueError("truncated printable container (header)")
    head = z85_core_decode(text[:hl], _HEADER.size)
    flags, nblocks = _printable_header(head)
    pos = hl + 1
    meta_len = nblocks * _ENTRY.size
    if flags & FLAG_SHARED_TABLE:
        # the shared-table length rides first in the meta region: decode
        # its armored group to learn tlen
        first = z85_core_decode(text[pos : pos + z85_core_len(4)], 4)
        (tlen,) = struct.unpack("<I", first)
        meta_len += 4 + tlen
    ml = z85_core_len(meta_len)
    if len(text) < pos + ml + 1 or text[pos + ml] != "\n":
        raise ValueError("truncated printable container (meta)")
    meta = z85_core_decode(text[pos : pos + ml], meta_len)
    pos += ml + 1
    payloads = []
    for cl in _comp_lens(meta, nblocks):
        pl = z85_core_len(cl)
        if len(text) < pos + pl:
            raise ValueError("truncated printable container (payload)")
        payloads.append(z85_core_decode(text[pos : pos + pl], cl))
        pos += pl
    return head + meta + b"".join(payloads)


def _read_exact(stream, n: int, what: str) -> bytes:
    buf = stream.read(n)
    if len(buf) != n:
        raise ValueError(f"truncated printable container ({what})")
    return buf


def read_printable_frame(stream, magic_consumed: bool = False) -> bytes:
    """Read one in-band printable container from a stream and return the
    equivalent BINARY frame bytes.  Every span length follows from data
    already read, so streamed printable containers need no lookahead: a
    printable stream is a concatenation of these, one per frame."""
    if not magic_consumed:
        if _read_exact(stream, len(PRINTABLE_MAGIC), "magic") != PRINTABLE_MAGIC:
            raise ValueError("not a printable container")
    hl = z85_core_len(_HEADER.size)
    head_txt = _read_exact(stream, hl + 1, "header")
    if head_txt[-1:] != b"\n":
        raise ValueError("truncated printable container (header)")
    head = z85_core_decode(head_txt[:-1].decode("ascii"), _HEADER.size)
    flags, nblocks = _printable_header(head)
    meta_len = nblocks * _ENTRY.size
    lead = b""
    if flags & FLAG_SHARED_TABLE:
        lead = _read_exact(stream, z85_core_len(4), "shared table length")
        (tlen,) = struct.unpack("<I", z85_core_decode(lead.decode("ascii"), 4))
        meta_len += 4 + tlen
    ml = z85_core_len(meta_len)
    rest = _read_exact(stream, ml - len(lead) + 1, "meta")
    if rest[-1:] != b"\n":
        raise ValueError("truncated printable container (meta)")
    meta = z85_core_decode((lead + rest[:-1]).decode("ascii"), meta_len)
    payloads = []
    for cl in _comp_lens(meta, nblocks):
        span = _read_exact(stream, z85_core_len(cl), "payload")
        payloads.append(z85_core_decode(span.decode("ascii"), cl))
    if _read_exact(stream, 1, "terminator") != b"\n":
        raise ValueError("truncated printable container (terminator)")
    return head + meta + b"".join(payloads)


def read_frame(stream) -> Optional[bytes]:
    """Read exactly one complete frame from a binary file object, or None
    at a clean EOF.  Streamed containers are concatenations of
    independent frames, so an unbounded input is never resident.  A
    printable container (PRINTABLE_MAGIC) is detected per frame and
    returned as its binary equivalent, so binary and printable frames
    may be mixed in one stream."""
    sniff = stream.read(4)
    if not sniff:
        return None
    if len(sniff) < 4:
        raise ValueError("truncated frame: header")
    if sniff == PRINTABLE_MAGIC[:4]:
        tail = stream.read(len(PRINTABLE_MAGIC) - 4)
        if sniff + tail != PRINTABLE_MAGIC:
            raise ValueError(f"bad magic {(sniff + tail)!r}")
        return read_printable_frame(stream, magic_consumed=True)
    header = sniff + stream.read(_HEADER.size - 4)
    if len(header) < _HEADER.size:
        raise ValueError("truncated frame: header")
    (magic, ver, flags, codec_id, _arity, _bsize, nblocks, _total, _cl2, hcrc) = (
        _HEADER.unpack_from(header, 0)
    )
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic!r}")
    if ver != VERSION:
        raise ValueError(f"unsupported version {ver}")
    if crc32(header[: _HEADER.size - 4]) != hcrc:
        raise ValueError("header CRC mismatch")
    _check_codec(codec_id)
    parts = [header]
    if flags & FLAG_SHARED_TABLE:
        raw = stream.read(4)
        if len(raw) < 4:
            raise ValueError("truncated frame: shared table length")
        (tlen,) = struct.unpack("<I", raw)
        table = stream.read(tlen)
        if len(table) != tlen:
            raise ValueError("truncated frame: shared table")
        parts += [raw, table]
    table_bytes = stream.read(nblocks * _ENTRY.size)
    if len(table_bytes) != nblocks * _ENTRY.size:
        raise ValueError("truncated frame: block table")
    parts.append(table_bytes)
    payload_total = sum(
        _ENTRY.unpack_from(table_bytes, k * _ENTRY.size)[0] for k in range(nblocks)
    )
    payload = stream.read(payload_total)
    if len(payload) != payload_total:
        raise ValueError("truncated frame: payload")
    parts.append(payload)
    return b"".join(parts)


def split_blocks(data: bytes, block_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Split a byte stream into a zero-padded [num_blocks, block_size]
    uint8 array plus per-block valid lengths."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr)
    if n == 0:
        return np.zeros((0, block_size), np.uint8), np.zeros((0,), np.int64)
    nblocks = -(-n // block_size)
    padded = np.zeros((nblocks, block_size), np.uint8)
    padded.reshape(-1)[:n] = arr
    lengths = np.full(nblocks, block_size, np.int64)
    lengths[-1] = n - (nblocks - 1) * block_size
    return padded, lengths
