"""Context-keyed LZW "small" codecs (byte and nybble variants);
counterpart of ``data_compression_tpu/models/small.py``, whose payloads
are byte-identical.

Reimplements the two schemes of small_compression.c:

Scheme A (``small_byte``, spec at small_compression.c:5-18): each
compressed byte is a word index; 32 contexts keyed on the low 5 bits of
the previous plaintext byte (byte_to_context :74-77); indexes 0x80-0xFE
reference a 127-entry per-context dictionary; the decoder rebuilds the
dictionary in lock-step, adding (previous word + first byte of next
word) each step (:473-482).

Scheme B (``small_nybble``): words are nybble strings, low-nybble-first
within a byte (little_endian write_nybble :1192-1215); literal nybbles
live at reserved indexes 0x10-0x1F (:803-805); every byte index
initially decodes to itself (:783-836); new word indexes allocate from
0x80 wrapping at 0x100 (increment_table_index :1330-1384).

The reference's scheme-A encoder is stubbed (its tree search is
commented out, :530-549) and its LZW special case is ``assert(0)``
(:428).  This module builds the real codec with **frozen-content
(span) semantics**: every dictionary entry is an immutable span of the
already-decoded output — ``(previous word's start, previous length+1)``
— which is the standard LZW dictionary model.  (The reference walks
(prefix, letter) chains through a *mutating* table, which changes old
entries' meaning after slot wrap-around and is exactly the bookkeeping
its unfinished encoder never resolved.)  Consequences:

  * the LZW special case (cScSc) needs no code at all: the span's last
    byte is by construction the first byte of the word being decoded,
    and a byte-serial (or 1-byte-fixup) copy materializes it;
  * decode is an LZ77-style copy loop;
  * the encoder tracks a per-slot generation counter so matches only
    extend through entries whose frozen prefix content is still the
    live content of the prefix slot.

Further deliberate fixes vs the reference, noted inline: slots allocate
from the context the entry is stored in (the reference draws the slot
from the *current* context's counter but stores into the *previous*
context's table, :480-482), and the initial previous-context is
``byte_to_context(' ')`` (the reference indexes ``dictionary[32]`` out
of bounds on its first update, :468).

Decoder behavior matches the reference on every stream the reference's
own tests exercise (mock-encoder streams never wrap slots or reuse
chains; verified in tests/test_small.py).

Routes (``LaneCodec``): made for a CUDA device, scheme A and scheme B
run in the small lanes (``ops/scan_codecs.py``, kernels in
``csrc/small_lanes.cu``: one warp per block to encode, one thread per
block to decode); made for the CPU, in the native runtime's OpenMP
batch drivers (``native``), the JAX package's production default.  On
either device encode takes the Python host encoders when ``stats`` are
collected (byte-identical payloads).  The ISPRINT (0x1f) mode has no
lane and no native driver: its blocks run the host encoder and decoder
on either device, as in the original, and the type-8 blocks of the same
frame take the device's route.  The ``*_host`` functions are the plain
versions the tests hold both routes to.
"""

from __future__ import annotations

from typing import List

import numpy as np

from data_compression_tpu_torch import native
from data_compression_tpu_torch.models.base import EncodeResult, LaneCodec
from data_compression_tpu_torch.models.nybble import seven_bit_blocks
from data_compression_tpu_torch.ops import scan_codecs

EIGHT_BIT_PRUNED = 8  # small_compression.c:39
ISPRINT_LITERAL = 0x1F  # ISPRINT_IS_ALWAYS_LITERAL, small_compression.c:36
NUM_CONTEXTS = 32
DICT_INDEXES = 0x7F  # 127 word slots per context (scheme A)
MAX_WORD = 256  # encoder match-length cap

# ISPRINT_IS_ALWAYS_LITERAL wire map: the reference reserves the mode
# byte and never implements it; its name states the invariant — any
# printable byte in the compressed stream is a literal.  Realized here
# as scheme A with the index space widened to EVERY non-printable byte
# value (0x00-0x1F, 0x7F-0xFF = 161 slots/context vs 127), slot order =
# ascending byte value.  Plaintext must itself be printable (0x20-0x7E).
_NP_BYTES = np.array(
    [b for b in range(256) if not (0x20 <= b <= 0x7E)], np.int32
)
_NP_SLOT = np.full(256, -1, np.int32)
_NP_SLOT[_NP_BYTES] = np.arange(_NP_BYTES.size, dtype=np.int32)
NP_SLOTS = int(_NP_BYTES.size)  # 161


def _ctx(byte: int) -> int:
    return byte & (NUM_CONTEXTS - 1)


# ----------------------------------------------------------------------
# Scheme A: byte-oriented context LZW (span dictionary)
# ----------------------------------------------------------------------


class _ByteDict:
    """Per-context span dictionary.  A slot holds either its default
    content (' ' + chr(i), start < 0 — initialize_dictionary,
    small_compression.c:171-196) or a frozen span (start, length) of
    the output; (prefix, prefix_gen, letter) exist for the encoder's
    match search."""

    def __init__(self, n_slots: int = DICT_INDEXES):
        self.n_slots = n_slots
        self.start = np.full((NUM_CONTEXTS, n_slots), -1, np.int64)
        self.length = np.full((NUM_CONTEXTS, n_slots), 2, np.int64)
        self.gen = np.zeros((NUM_CONTEXTS, n_slots), np.int64)
        self.prefix = np.full((NUM_CONTEXTS, n_slots), ord(" "), np.int32)
        self.prefix_gen = np.zeros((NUM_CONTEXTS, n_slots), np.int64)
        self.letter = np.tile(
            np.arange(n_slots, dtype=np.int32), (NUM_CONTEXTS, 1)
        )
        self.letter[:, 0] = ord("x")  # default for slot 0 (:185)
        if n_slots > DICT_INDEXES:
            # isprint mode's extra slots start empty (no default words):
            # sentinel letter never matches a real byte
            self.letter[:, DICT_INDEXES:] = -1
        self.nwi = np.zeros(NUM_CONTEXTS, np.int32)

    def add(self, prev_context, prev_index, prev_pos, prev_len, first_byte,
            prev_slot=None):
        """Lock-step insert: new word = previous word + 1 byte, i.e. the
        span (prev_pos, prev_len + 1).  ``prev_slot``: dict slot of
        prev_index, or -1 for a literal (None = scheme-A 0x80 rule)."""
        if prev_slot is None:
            prev_slot = prev_index - 0x80 if prev_index >= 0x80 else -1
        s = int(self.nwi[prev_context])
        self.start[prev_context, s] = prev_pos
        self.length[prev_context, s] = prev_len + 1
        self.gen[prev_context, s] += 1
        self.prefix[prev_context, s] = prev_index
        if prev_slot >= 0:
            self.prefix_gen[prev_context, s] = self.gen[prev_context, prev_slot]
        else:
            self.prefix_gen[prev_context, s] = 0
        self.letter[prev_context, s] = first_byte
        self.nwi[prev_context] = (s + 1) % self.n_slots

    def emit_slot(self, context, s, out: bytearray) -> int:
        """Append slot s's word to out; returns its length."""
        st = int(self.start[context, s])
        ln = int(self.length[context, s])
        if st < 0:  # default entry: ' ' + chr(s)
            out.append(ord(" "))
            out.append(ord("x") if s == 0 or s >= DICT_INDEXES else s)
            return 2
        for k in range(ln):  # byte-serial copy handles self-overlap
            out.append(out[st + k])
        return ln

    def emit(self, context, index, out: bytearray) -> int:
        """Scheme-A wire mapping: index < 0x80 literal, else slot."""
        if index < 0x80:
            out.append(index)
            return 1
        if index - 0x80 >= self.n_slots:  # 0xFF: the original raises IndexError
            raise ValueError(f"bad small_byte word index {index:#x}")
        return self.emit_slot(context, index - 0x80, out)

    def find_child(self, context, index, byte, banned, slot=None) -> int:
        """Lowest slot whose frozen content = content(index) + byte.
        ``slot``: dict slot of index, or -1 for a literal prefix (None =
        scheme-A 0x80 rule)."""
        if slot is None:
            slot = index - 0x80 if index >= 0x80 else -1
        ok = (self.prefix[context] == index) & (self.letter[context] == byte)
        if slot >= 0:
            ok &= self.prefix_gen[context] == self.gen[context, slot]
        hits = np.flatnonzero(ok)
        for w in hits:
            if int(w) != banned:
                return int(w)
        return -1


def small_byte_encode_host(src: bytes, stats=None) -> bytes:
    """Greedy longest-match encoder (the real version of the stubbed
    compress_byte_index, small_compression.c:507-565).

    ``stats``: optional utils.debug.CodecStats(32) — per-context
    dictionary-word hits vs literal emissions (the reference's
    times_used_directly counters, small_compression.c:133-134)."""
    out = bytearray([EIGHT_BIT_PRUNED])
    if not src:
        return bytes(out)
    if max(src) >= 0x80:
        raise ValueError("small_byte codec requires 7-bit plaintext")
    out.append(src[0])
    d = _ByteDict()
    prev_context = _ctx(ord(" "))  # fixed init (ref indexes OOB, :468)
    prev_index = src[0]
    prev_pos, prev_len = 0, 1
    pos = 1
    n = len(src)
    while pos < n:
        context = _ctx(src[pos - 1])
        banned = int(d.nwi[prev_context]) if context == prev_context else -1
        index = src[pos]
        length = 1
        while pos + length < n and length < MAX_WORD - 1:
            w = d.find_child(context, index, src[pos + length], banned)
            if w < 0:
                break
            index = 0x80 + w
            length += 1
        out.append(index)
        if stats is not None:
            stats.hit(context) if index >= 0x80 else stats.literal()
        d.add(prev_context, prev_index, prev_pos, prev_len, src[pos])
        prev_context, prev_index = context, index
        prev_pos, prev_len = pos, length
        pos += length
    return bytes(out)


def small_byte_decode_host(payload: bytes, raw_len: int) -> bytes:
    """Lock-step span decoder (decompress_bytestring, :453-505)."""
    if raw_len == 0:
        return b""
    if not payload or payload[0] != EIGHT_BIT_PRUNED:
        raise ValueError("bad small_byte stream type byte")
    if len(payload) < 2:  # the original raises IndexError here
        raise ValueError("truncated small_byte stream")
    out = bytearray([payload[1]])
    d = _ByteDict()
    prev_context = _ctx(ord(" "))
    prev_index = payload[1]
    prev_pos, prev_len = 0, 1
    i = 2
    while len(out) < raw_len:
        if i >= len(payload):
            raise ValueError("truncated small_byte stream")
        index = payload[i]
        i += 1
        context = _ctx(out[-1])
        pos = len(out)
        wl = d.emit(context, index, out)
        # insert AFTER emit start position is known; first byte of the
        # current word is out[pos]
        d.add(prev_context, prev_index, prev_pos, prev_len, out[pos])
        prev_context, prev_index = context, index
        prev_pos, prev_len = pos, wl
    if len(out) != raw_len:
        raise ValueError("small_byte stream decoded past expected length")
    return bytes(out)


def small_isprint_encode_host(src: bytes, stats=None) -> bytes:
    """ISPRINT_IS_ALWAYS_LITERAL encoder (mode byte 0x1f,
    small_compression.c:36 — reserved in the reference's enum, never
    implemented).  The mode's invariant is its name: any printable byte
    in the compressed stream is a literal; every NON-printable byte
    value is a per-context dictionary word index, giving 161 slots per
    context (vs scheme A's 127).  Plaintext must be printable
    (0x20-0x7E)."""
    out = bytearray([ISPRINT_LITERAL])
    if not src:
        return bytes(out)
    arr = np.frombuffer(src, np.uint8)
    if int(arr.min()) < 0x20 or int(arr.max()) > 0x7E:
        raise ValueError("isprint mode requires printable plaintext")
    out.append(src[0])
    d = _ByteDict(NP_SLOTS)
    prev_context = _ctx(ord(" "))
    prev_index = src[0]
    prev_pos, prev_len = 0, 1
    pos = 1
    n = len(src)
    while pos < n:
        context = _ctx(src[pos - 1])
        banned = int(d.nwi[prev_context]) if context == prev_context else -1
        index = src[pos]
        length = 1
        while pos + length < n and length < MAX_WORD - 1:
            w = d.find_child(
                context, index, src[pos + length], banned,
                slot=int(_NP_SLOT[index]),
            )
            if w < 0:
                break
            index = int(_NP_BYTES[w])
            length += 1
        out.append(index)
        if stats is not None:
            stats.hit(context) if _NP_SLOT[index] >= 0 else stats.literal()
        d.add(
            prev_context, prev_index, prev_pos, prev_len, src[pos],
            prev_slot=int(_NP_SLOT[prev_index]),
        )
        prev_context, prev_index = context, index
        prev_pos, prev_len = pos, length
        pos += length
    return bytes(out)


def small_isprint_decode_host(payload: bytes, raw_len: int) -> bytes:
    """Lock-step decoder for the 0x1f mode: printable stream bytes are
    literals, non-printable bytes index the span dictionary."""
    if raw_len == 0:
        return b""
    if not payload or payload[0] != ISPRINT_LITERAL:
        raise ValueError("bad small_isprint stream type byte")
    if len(payload) < 2:  # the original raises IndexError here
        raise ValueError("truncated small_isprint stream")
    out = bytearray([payload[1]])
    d = _ByteDict(NP_SLOTS)
    prev_context = _ctx(ord(" "))
    prev_index = payload[1]
    prev_pos, prev_len = 0, 1
    i = 2
    while len(out) < raw_len:
        if i >= len(payload):
            raise ValueError("truncated small_isprint stream")
        index = payload[i]
        i += 1
        context = _ctx(out[-1])
        pos = len(out)
        slot = int(_NP_SLOT[index])
        if slot < 0:  # printable is always literal
            out.append(index)
            wl = 1
        else:
            wl = d.emit_slot(context, slot, out)
        d.add(
            prev_context, prev_index, prev_pos, prev_len, out[pos],
            prev_slot=int(_NP_SLOT[prev_index]),
        )
        prev_context, prev_index = context, index
        prev_pos, prev_len = pos, wl
    if len(out) != raw_len:
        raise ValueError("small_isprint stream decoded past expected length")
    return bytes(out)


# ----------------------------------------------------------------------
# Scheme B: nybble-oriented context LZW (span dictionary, nybble coords)
# ----------------------------------------------------------------------

WORD_INDEXES = 256


def _is_literal_index(x: int) -> bool:
    return (x | 0xF) == 0x1F  # small_compression.c:805


class _NybbleTable:
    """Spans are in *nybble* coordinates over the decoded nybble
    stream.  Defaults: byte index i = its own two nybbles, low first
    (initialize_table, :783-836); literal indexes 0x10-0x1F are single
    nybbles."""

    def __init__(self):
        self.start = np.full((NUM_CONTEXTS, WORD_INDEXES), -1, np.int64)
        self.length = np.zeros((NUM_CONTEXTS, WORD_INDEXES), np.int64)
        self.gen = np.zeros((NUM_CONTEXTS, WORD_INDEXES), np.int64)
        idx = np.arange(WORD_INDEXES, dtype=np.int32)
        self.prefix = np.tile((idx & 0x0F) | 0x10, (NUM_CONTEXTS, 1))
        self.prefix_gen = np.zeros((NUM_CONTEXTS, WORD_INDEXES), np.int64)
        self.letter = np.tile((idx >> 4) & 0x0F, (NUM_CONTEXTS, 1))
        self.nwi = np.full(NUM_CONTEXTS, 0x80, np.int32)

    def add(self, prev_context, prev_index, prev_pos, prev_len, first_nybble):
        s = int(self.nwi[prev_context])
        self.start[prev_context, s] = prev_pos
        self.length[prev_context, s] = prev_len + 1
        self.gen[prev_context, s] += 1
        self.prefix[prev_context, s] = prev_index
        if (
            prev_index >= 0
            and not _is_literal_index(prev_index)
            and self.start[prev_context, prev_index] >= 0
        ):
            self.prefix_gen[prev_context, s] = self.gen[prev_context, prev_index]
        else:
            self.prefix_gen[prev_context, s] = 0
        self.letter[prev_context, s] = first_nybble
        nxt = s + 1
        if nxt >= 0x100:  # wraptype only_hi_bit_set (:1343-1348)
            nxt = 0x80
        self.nwi[prev_context] = nxt

    def emit(self, context, index, nybs: List[int]) -> int:
        if _is_literal_index(index):
            nybs.append(index & 0xF)
            return 1
        st = int(self.start[context, index])
        ln = int(self.length[context, index])
        if st < 0:  # default: the byte's own two nybbles, low first
            nybs.append(index & 0xF)
            nybs.append((index >> 4) & 0xF)
            return 2
        for k in range(ln):
            nybs.append(nybs[st + k])
        return ln

    def find_child(self, context, index, nyb, banned) -> int:
        ok = (self.prefix[context] == index) & (self.letter[context] == nyb)
        if not _is_literal_index(index):
            if self.start[context, index] >= 0:
                ok &= self.prefix_gen[context] == self.gen[context, index]
            else:
                ok &= self.prefix_gen[context] == 0
        lit = np.zeros(WORD_INDEXES, bool)
        lit[0x10:0x20] = True
        ok &= ~lit
        hits = np.flatnonzero(ok)
        for w in hits:
            if int(w) != banned:
                return int(w)
        return -1


def _byte_nybbles(data: bytes) -> List[int]:
    """Low nybble first (little_endian, small_compression.c:795-801)."""
    out = []
    for b in data:
        out.append(b & 0xF)
        out.append((b >> 4) & 0xF)
    return out


def small_nybble_encode_host(src: bytes, stats=None) -> bytes:
    """Spans index the FULL nybble stream (verbatim first byte
    included), so the first lock-step insert is an ordinary span.

    ``stats``: optional utils.debug.CodecStats(32) — literal-nybble
    emissions vs dictionary-word emissions per context."""
    out = bytearray([EIGHT_BIT_PRUNED])
    if not src:
        return bytes(out)
    out.append(src[0])
    t = _NybbleTable()
    nybs = _byte_nybbles(src)
    N = len(nybs)
    prev_context = _ctx(ord(" "))
    # -1 sentinel: the verbatim first byte is not an index (a raw byte
    # value in 0x10-0x1F would collide with the literal-nybble range).
    prev_index = -1
    prev_pos, prev_len = 0, 2  # the verbatim first byte's two nybbles
    pos = 2
    while pos < N:
        # last complete output byte (output == input): src[pos//2 - 1]
        context = _ctx(src[pos // 2 - 1])
        banned = int(t.nwi[prev_context]) if context == prev_context else -1
        index = nybs[pos] | 0x10
        length = 1
        while pos + length < N and length < 2 * MAX_WORD - 1:
            w = t.find_child(context, index, nybs[pos + length], banned)
            if w < 0:
                break
            index = w
            length += 1
        out.append(index)
        if stats is not None:
            if _is_literal_index(index):
                stats.literal()
            else:
                stats.hit(context)
        t.add(prev_context, prev_index, prev_pos, prev_len, nybs[pos])
        prev_context, prev_index = context, index
        prev_pos, prev_len = pos, length
        pos += length
    return bytes(out)


def small_nybble_decode_host(payload: bytes, raw_len: int) -> bytes:
    if raw_len == 0:
        return b""
    if not payload or payload[0] != EIGHT_BIT_PRUNED:
        raise ValueError("bad small_nybble stream type byte")
    if len(payload) < 2:  # the original raises IndexError here
        raise ValueError("truncated small_nybble stream")
    first = payload[1]
    t = _NybbleTable()
    nybs: List[int] = [first & 0xF, (first >> 4) & 0xF]
    prev_context = _ctx(ord(" "))
    prev_index = -1  # sentinel, see encoder
    prev_pos, prev_len = 0, 2
    i = 2
    target = 2 * raw_len
    while len(nybs) < target:
        if i >= len(payload):
            raise ValueError("truncated small_nybble stream")
        index = payload[i]
        i += 1
        done = len(nybs) // 2  # complete output bytes so far
        context = _ctx(nybs[2 * done - 2] | (nybs[2 * done - 1] << 4))
        pos = len(nybs)
        wl = t.emit(context, index, nybs)
        t.add(prev_context, prev_index, prev_pos, prev_len, nybs[pos])
        prev_context, prev_index = context, index
        prev_pos, prev_len = pos, wl
    if len(nybs) != target:
        raise ValueError("small_nybble stream decoded past expected length")
    out = bytearray()
    for k in range(0, len(nybs), 2):
        out.append(nybs[k] | (nybs[k + 1] << 4))
    return bytes(out)


# ----------------------------------------------------------------------
# Codec wrappers
# ----------------------------------------------------------------------


class SmallByteCodec(LaneCodec):
    name = "small_byte"

    def encode_blocks(
        self, blocks: np.ndarray, lengths: np.ndarray, stats=None
    ) -> EncodeResult:
        B = blocks.shape[0]
        lengths = np.asarray(lengths, np.int64)
        payloads = [None] * B
        todo = np.ones(B, bool)
        if self.config.isprint_literal:
            # 0x1f mode: all-printable blocks ride it; others keep the
            # standard scheme-A stream (mixed frames are valid — decode
            # dispatches on each block's type byte)
            pos = np.arange(blocks.shape[1])[None, :] < lengths[:, None]
            printable = ~np.any(((blocks < 0x20) | (blocks > 0x7E)) & pos, axis=1)
            for i in np.flatnonzero(printable):
                payloads[i] = small_isprint_encode_host(
                    blocks[i, : int(lengths[i])].tobytes(), stats=stats
                )
            todo &= ~printable
        if stats is None and self.on_card:  # the lane returns blocks with bytes >= 0x80 raw
            idx = np.flatnonzero(todo)
            if idx.size:
                rows = blocks if idx.size == B else blocks[idx]
                enc = scan_codecs.small_byte_encode_blocks(rows, lengths[idx], self.device)
                for k, i in enumerate(idx):
                    payloads[i] = enc[k]
            return EncodeResult(payloads=payloads)
        idx = np.flatnonzero(todo & seven_bit_blocks(blocks, lengths))
        if stats is not None:  # stats collection rides the host encoder (byte-identical output)
            for i in idx:
                payloads[i] = small_byte_encode_host(
                    blocks[i, : int(lengths[i])].tobytes(), stats=stats
                )
        elif idx.size:
            enc = native.encode_batch("small_byte", blocks[idx], lengths[idx])
            for k, i in enumerate(idx):
                payloads[i] = enc[k]
        for i in range(B):
            if payloads[i] is None:  # bytes >= 0x80: the LITERAL fallback
                payloads[i] = blocks[i, : int(lengths[i])].tobytes()
        return EncodeResult(payloads=payloads)

    def decode_blocks(self, payloads, raw_lens, shared_table=None):
        # per-block type dispatch: 0x1f blocks ride the host isprint
        # decoder, type-8 blocks the device's route
        out = [None] * len(payloads)
        for i, p in enumerate(payloads):
            if p and p[0] == ISPRINT_LITERAL:
                out[i] = small_isprint_decode_host(p, raw_lens[i])
        rest = [i for i in range(len(payloads)) if out[i] is None]
        rest_payloads = [payloads[i] for i in rest]
        rest_lens = [raw_lens[i] for i in rest]
        if self.on_card:
            dec = scan_codecs.decode_payloads("small_byte", rest_payloads, rest_lens, self.device)
        else:
            dec = native.decode_batch("small_byte", rest_payloads, rest_lens)
        for i, blk in zip(rest, dec):
            out[i] = blk
        return out


class SmallNybbleCodec(LaneCodec):
    name = "small_nybble"

    def encode_blocks(
        self, blocks: np.ndarray, lengths: np.ndarray, stats=None
    ) -> EncodeResult:
        if stats is None and self.on_card:
            return EncodeResult(scan_codecs.small_nybble_encode_blocks(blocks, lengths, self.device))
        if stats is None:
            return EncodeResult(payloads=native.encode_batch("small_nybble", blocks, lengths))
        payloads = []
        for i in range(blocks.shape[0]):
            raw = blocks[i, : int(lengths[i])].tobytes()
            payloads.append(small_nybble_encode_host(raw, stats=stats))
        return EncodeResult(payloads=payloads)

    def decode_blocks(self, payloads, raw_lens, shared_table=None):
        if self.on_card:
            return scan_codecs.decode_payloads("small_nybble", payloads, raw_lens, self.device)
        return native.decode_batch("small_nybble", payloads, raw_lens)
