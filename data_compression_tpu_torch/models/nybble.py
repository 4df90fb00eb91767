"""16-context move-to-front nybble codec (counterpart of
``data_compression_tpu/models/nybble.py``; its payloads are
byte-identical).

Bit-exact reimplementation of the one fully-working reference scheme
(nybble_compression.c; spec at :9-31, :112-131):

* Compressed stream is nybble-oriented, hi-nybble-first within a byte
  (decompress_bytestring, nybble_compression.c:767-773).
* A nybble with hi bit 1 indexes one of 8 predicted bytes for the
  current context (low 3 bits); a nybble with hi bit 0 starts a 2-nybble
  literal equal to the plaintext byte (so 7-bit bytes represent
  themselves, decompress_nybble :643-663).
* 16 contexts keyed on bits 3-6 of the previous *output* byte
  (byte_to_context :517-523); each context row of 8 bytes is seeded
  with " etaoins" (initialize_dictionary :546-562) and maintained
  move-to-front (update_context :665-687).
* The encoder keeps literals byte-aligned: a miss at odd nybble offset
  re-expands the previous byte's compressed nybble into a full literal
  byte (compress_byte_index :848-858); a trailing odd nybble is flushed
  the same way (compress_bytestring :1000-1009).

Stream layout (identical to the reference): type byte 0xAF, first
plaintext byte verbatim (context seed), then the nybble stream.  The
LITERAL-fallback decision (strlen(compressed) >= strlen(source),
:1018-1037) is applied by the framing layer with the same threshold.

Scope: plaintext bytes must be < 0x80 (the reference asserts the same,
:910); embedded 0x00 bytes are legal.  Blocks containing bytes >= 0x80
are passed through as LITERAL blocks.

Routes, as the JAX package's production default: both directions run
in the native runtime's OpenMP batch drivers (``native``) on the host,
whatever the codec's device (``HostCodec``); encode takes the Python
host encoder ``encode_host`` only when ``stats`` are collected
(byte-identical payloads).  ``encode_host`` / ``decode_host`` are the
plain versions the tests hold the native route to.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from data_compression_tpu_torch import native
from data_compression_tpu_torch.models.base import EncodeResult, HostCodec

NYBBLES_TYPE = 0xAF  # nybble_compression.c:732
SEED_ROW = b" etaoins"  # nybble_compression.c:546-562
NUM_CONTEXTS = 16
LETTERS_PER_CONTEXT = 8


def _ctx(byte: int) -> int:
    return (byte >> 3) & (NUM_CONTEXTS - 1)


def _new_table() -> list:
    return [list(SEED_ROW) for _ in range(NUM_CONTEXTS)]


def _mtf_update(table: list, ctx: int, byte: int) -> None:
    """Move-to-front insert (update_context, nybble_compression.c:665-687)."""
    row = table[ctx]
    new = byte
    for pos in range(LETTERS_PER_CONTEXT):
        old = row[pos]
        row[pos] = new
        new = old
        if new == byte:
            break


def encode_host(src: bytes, modify: bool = True, stats=None) -> bytes:
    """Reference-exact encoder (compress_bytestring minus the fallback).

    ``stats``: optional utils.debug.CodecStats — records per-context
    prediction hits vs literals (the reference's times_used_directly
    counters, nybble_compression.c:543)."""
    out = bytearray([NYBBLES_TYPE])
    if not src:
        return bytes(out)
    out.append(src[0])
    table = _new_table()
    pending = -1  # compressed nybble occupying a half-filled byte, else -1
    for i in range(1, len(src)):
        p = src[i - 1]
        s = src[i]
        if s >= 0x80 or p >= 0x80:
            raise ValueError("nybble codec requires 7-bit plaintext")
        ctx = _ctx(p)
        row = table[ctx]
        try:
            pos = row.index(s)
        except ValueError:
            pos = -1
        if stats is not None:
            stats.hit(ctx) if pos >= 0 else stats.literal()
        if pos >= 0:
            nyb = 0x8 | pos
            if pending < 0:
                pending = nyb
            else:
                out.append((pending << 4) | nyb)
                pending = -1
        else:
            if pending < 0:
                out.append(s)
            else:
                # Re-expand previous byte to a literal to stay aligned
                # (compress_byte_index, nybble_compression.c:848-858).
                out.append(p)
                out.append(s)
                pending = -1
        if modify:
            _mtf_update(table, ctx, s)
    if pending >= 0:
        # Trailing odd nybble flushed as a literal
        # (compress_bytestring, nybble_compression.c:1000-1009).
        out.append(src[-1])
    return bytes(out)


def decode_host(payload: bytes, raw_len: int, modify: bool = True) -> bytes:
    """Reference-exact decoder (decompress_bytestring,
    nybble_compression.c:734-817), length-driven instead of
    NUL-terminated."""
    if raw_len == 0:
        return b""
    if not payload:
        raise ValueError("empty payload")
    t = payload[0]
    if t != NYBBLES_TYPE:
        raise ValueError(f"bad nybble stream type byte {t:#x}")
    if len(payload) < 2:
        raise ValueError("truncated payload")
    out = bytearray([payload[1]])
    data = payload[2:]
    table = _new_table()
    j = 0  # nybble cursor
    while len(out) < raw_len:
        bidx = j >> 1
        if bidx >= len(data):
            raise ValueError("truncated nybble stream")
        b = data[bidx]
        nyb = (b >> 4) & 0xF if (j & 1) == 0 else b & 0xF
        if nyb & 0x8:
            o = table[_ctx(out[-1])][nyb & 0x7]
            used = 1
        else:
            j2 = j + 1
            b2idx = j2 >> 1
            if b2idx >= len(data):
                raise ValueError("truncated literal")
            b2 = data[b2idx]
            nxt = (b2 >> 4) & 0xF if (j2 & 1) == 0 else b2 & 0xF
            o = ((nyb & 0x7) << 4) | nxt
            used = 2
        if modify:
            _mtf_update(table, _ctx(out[-1]), o)
        out.append(o)
        j += used
    return bytes(out)


def seven_bit_blocks(blocks: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """[B] bool: the blocks whose valid bytes are all < 0x80."""
    pos = np.arange(blocks.shape[1])[None, :] < lengths[:, None]
    return ~np.any((blocks >= 0x80) & pos, axis=1)


class NybbleCodec(HostCodec):
    name = "nybble"

    def encode_blocks(
        self, blocks: np.ndarray, lengths: np.ndarray, stats=None
    ) -> EncodeResult:
        B = blocks.shape[0]
        lengths = np.asarray(lengths, np.int64)
        # Blocks with bytes >= 0x80 can't ride the 7-bit scheme
        # (nybble_compression.c:910 asserts the same); they take the
        # LITERAL fallback via an incompressible payload.
        ok = seven_bit_blocks(blocks, lengths)
        payloads: List[Optional[bytes]] = [None] * B
        idx = np.flatnonzero(ok)
        if stats is None:
            enc = native.encode_batch("nybble", blocks[idx], lengths[idx]) if idx.size else []
            for k, i in enumerate(idx):
                payloads[i] = enc[k]
        else:  # stats collection rides the host encoder (byte-identical output)
            for i in idx:
                payloads[i] = encode_host(
                    blocks[i, : int(lengths[i])].tobytes(), stats=stats
                )
        for i in np.flatnonzero(~ok):
            payloads[i] = blocks[i, : int(lengths[i])].tobytes()
        return EncodeResult(payloads=payloads)

    def decode_blocks(
        self,
        payloads: List[bytes],
        raw_lens: List[int],
        shared_table: Optional[bytes] = None,
    ) -> List[bytes]:
        return native.decode_batch("nybble", payloads, raw_lens)
