"""Observability / debug tooling (copy of ``data_compression_tpu/utils/debug.py``).

Reference analogues, kept because they are the reference's entire
debugging story (SURVEY.md §5):

* ``print_as_c_literal`` / ``print_as_c_string``
  (nybble_compression.c:564-641, duplicated in small_compression.c):
  emit bytes as a C string literal with the hex-escape/hex-digit
  collision handling, for embedding compressed data in (Arduino)
  source.
* ``debug_print_dictionary_contents`` (nybble_compression.c:694-719):
  dump the 16x8 MTF context table.
* the exhaustively-commented decode trace — "compressed byte on the
  left, decoded word on the right" (nybble_compression.c:722-731,
  small_compression.c:443-451).
* per-context use counters (``times_used_directly``,
  nybble_compression.c:543,683) as opt-in codec stats.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple


def c_literal(data: bytes, width: int = 70) -> str:
    """Bytes as a C string literal (print_as_c_literal,
    nybble_compression.c:564-631), including the guard against a hex
    escape swallowing a following hex digit (:588-597)."""
    out = ['"']
    line = 0
    avoid_hex = False

    def brk():
        nonlocal line, avoid_hex
        out.append('"\n  "')
        line = 3
        avoid_hex = False

    for b in data:
        if line >= width:
            brk()
        c = chr(b)
        if c == '"':
            out.append('\\"')
            line += 2
            avoid_hex = False
        elif c == "\\":
            out.append("\\\\")
            line += 2
            avoid_hex = False
        elif avoid_hex and c in "0123456789abcdefABCDEF":
            out.append('" "' + c)
            line += 4
            avoid_hex = False
        elif 0x20 <= b < 0x7F:
            out.append(c)
            line += 1
            avoid_hex = False
        elif c == "\n":
            out.append("\\n")
            line += 2
            avoid_hex = False
        elif c == "\t":
            out.append("\\t")
            line += 2
            avoid_hex = False
        else:
            out.append(f"\\x{b >> 4:x}{b & 0xF:x}")
            line += 4
            avoid_hex = True
    out.append('"')
    return "".join(out)


def c_string(data: bytes, name: str = "compressed_data") -> str:
    """print_as_c_string (nybble_compression.c:637-641)."""
    return f"char {name}[] =\n{c_literal(data)}; /* {len(data)} bytes. */\n"


def dump_nybble_table(table: List[List[int]]) -> str:
    """Render a 16x8 MTF context table
    (debug_print_dictionary_contents, nybble_compression.c:694-719)."""
    lines = ["nybble MTF dictionary:"]
    for ctx, row in enumerate(table):
        cells = " ".join(
            chr(b) if 0x20 <= b < 0x7F else f"\\x{b:02x}" for b in row
        )
        lines.append(f"  ctx {ctx:2d} (prev bits 3-6={ctx:04b}): [{cells}]")
    return "\n".join(lines)


def trace_nybble_decode(payload: bytes, raw_len: int) -> Iterator[Tuple[str, str]]:
    """Yield (compressed unit, decoded byte) pairs — the reference's
    annotated decode idea (nybble_compression.c:722-731).  Pure
    observation; re-runs the host decoder step by step."""
    from data_compression_tpu_torch.models.nybble import (
        NYBBLES_TYPE,
        _ctx,
        _mtf_update,
        _new_table,
    )

    if raw_len == 0 or not payload or payload[0] != NYBBLES_TYPE:
        return
    yield ("(type 0xAF)", "")
    yield (c_literal(payload[1:2]), c_literal(payload[1:2]))
    out = bytearray([payload[1]])
    data = payload[2:]
    table = _new_table()
    j = 0
    while len(out) < raw_len:
        b = data[j >> 1]
        nyb = (b >> 4) & 0xF if (j & 1) == 0 else b & 0xF
        if nyb & 0x8:
            o = table[_ctx(out[-1])][nyb & 0x7]
            unit = f"nybble {nyb:#x} (ctx {_ctx(out[-1])} slot {nyb & 7})"
            used = 1
        else:
            j2 = j + 1
            b2 = data[j2 >> 1]
            nxt = (b2 >> 4) & 0xF if (j2 & 1) == 0 else b2 & 0xF
            o = ((nyb & 0x7) << 4) | nxt
            unit = f"literal {o:#04x}"
            used = 2
        _mtf_update(table, _ctx(out[-1]), o)
        out.append(o)
        j += used
        yield (unit, c_literal(bytes([o])))


class CodecStats:
    """Opt-in per-context use counters (times_used_directly,
    nybble_compression.c:543)."""

    def __init__(self, num_contexts: int = 16):
        self.times_used_directly = [0] * num_contexts
        self.literals = 0
        self.hits = 0

    def hit(self, ctx: int):
        self.times_used_directly[ctx] += 1
        self.hits += 1

    def literal(self):
        self.literals += 1

    def summary(self) -> str:
        total = self.hits + self.literals
        pct = 100.0 * self.hits / total if total else 0.0
        return (
            f"hits {self.hits}, literals {self.literals} ({pct:.1f}% predicted); "
            f"per-context {self.times_used_directly}"
        )


def dump_small_dictionary(d, out: bytes, max_entries: int = 40) -> str:
    """Render a scheme-A span dictionary's non-default entries
    (debug_print_dictionary_entry/contents, small_compression.c:322-374
    — "decode every entry that differs from its default").  ``d``: a
    models.small._ByteDict after decoding ``out``; spans render as the
    actual output bytes they freeze."""
    lines = ["small span dictionary (non-default entries):"]
    shown = 0
    for ctx in range(d.start.shape[0]):
        for s in range(d.start.shape[1]):
            st = int(d.start[ctx, s])
            if st < 0:
                continue
            ln = int(d.length[ctx, s])
            word = bytes(out[st : st + ln])
            lines.append(
                f"  ctx {ctx:2d} slot {s:3d}: ({st},{ln}) {c_literal(word)}"
            )
            shown += 1
            if shown >= max_entries:
                lines.append(f"  ... (capped at {max_entries})")
                return "\n".join(lines)
    if shown == 0:
        lines.append("  (all defaults)")
    return "\n".join(lines)
