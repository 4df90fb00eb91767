"""Printable armor: base64url, Z85 and Ascii85 (jax-free copy of
``data_compression_tpu/utils/base64url.py``; the tests hold every text
and every error here equal to the original's).

Difference: ``z85_core`` / ``z85_core_decode``, which armor every span
of the printable container (``framing.frame_to_printable``), work on all
4-byte groups at once in numpy instead of one group at a time in
Python: the same text, and the same ``ValueError`` for a span of the
wrong length, a character outside the alphabet (the first in text
order) or a group above ``0xFFFFFFFF``.  ``z85_armor``'s body is
``z85_core``'s text, so it takes the vectorised encoder too.

Armor format: 'D' 'C' '1' header, then base64url of the payload, 76
chars per line, '.' terminator.
"""

from __future__ import annotations

import numpy as np

_ALPHABET = (
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "abcdefghijklmnopqrstuvwxyz"
    "0123456789"
    "-_"
)
_DECODE = {c: i for i, c in enumerate(_ALPHABET)}
# the reference's digit2int also accepts the RFC 4648 standard pair
# (n_ary_huffman.c:444-447)
_DECODE["+"] = 62
_DECODE["/"] = 63

_MAGIC = "DC1"
_LINE = 76


def int2digit(i: int) -> str:
    """n_ary_huffman.c:371-428."""
    if not 0 <= i < 64:
        raise ValueError("digit out of range")
    return _ALPHABET[i]


def digit2int(c: str) -> int:
    """n_ary_huffman.c:430-455."""
    try:
        return _DECODE[c]
    except KeyError:
        raise ValueError(f"not a base64url digit: {c!r}") from None


def armor(data: bytes) -> str:
    """Encode bytes as printable base64url text."""
    digits = []
    acc = 0
    nbits = 0
    for b in data:
        acc = (acc << 8) | b
        nbits += 8
        while nbits >= 6:
            nbits -= 6
            digits.append(_ALPHABET[(acc >> nbits) & 63])
    if nbits:
        digits.append(_ALPHABET[(acc << (6 - nbits)) & 63])
    body = "".join(digits)
    lines = [
        body[i : i + _LINE] for i in range(0, max(len(body), 1), _LINE)
    ] or [""]
    return _MAGIC + ":" + str(len(data)) + "\n" + "\n".join(lines) + "\n.\n"


def dearmor(text: str) -> bytes:
    """Inverse of armor (whitespace-tolerant)."""
    head, _, rest = text.partition("\n")
    if not head.startswith(_MAGIC + ":"):
        raise ValueError("bad armor header")
    nbytes = int(head[len(_MAGIC) + 1 :])
    acc = 0
    nbits = 0
    out = bytearray()
    for c in rest:
        if c in " \t\r\n":
            continue
        if c == ".":
            break
        acc = (acc << 6) | digit2int(c)
        nbits += 6
        if nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
    if len(out) < nbytes:
        raise ValueError("truncated armor")
    return bytes(out[:nbytes])


# --- Z85 armor (ZeroMQ Z85: 4 bytes -> 5 printable chars) -------------

_Z85 = (
    "0123456789abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    ".-:+=^!/*?&<>()[]{}@%$#"
)
_Z85_DECODE = {c: i for i, c in enumerate(_Z85)}
_Z85_MAGIC = "DCZ"
_Z85_CHARS = np.frombuffer(_Z85.encode("ascii"), np.uint8)
# digit value of each code point below 256; -1 outside the alphabet
_Z85_VALUE = np.full(256, -1, np.int64)
_Z85_VALUE[_Z85_CHARS] = np.arange(85)
_POW85 = (85**4, 85**3, 85**2, 85, 1)


def z85_core(data: bytes) -> str:
    """Raw Z85 body (no frame lines): ceil(len/4)*5 chars — the
    deterministic length makes per-block armored spans computable from
    the binary block table (framing.frame_to_printable)."""
    data = bytes(data)
    pad = (-len(data)) % 4
    groups = np.frombuffer(data + b"\x00" * pad, ">u4").astype(np.uint32)
    digits = np.empty((groups.size, 5), np.uint8)
    for i, p in enumerate(_POW85):
        digits[:, i] = _Z85_CHARS[(groups // np.uint32(p)) % 85]
    return digits.tobytes().decode("ascii")


def z85_core_len(nbytes: int) -> int:
    return -(-nbytes // 4) * 5


def _code_points(text: str) -> np.ndarray:
    """The characters of ``text`` as code points (clipped to 255, where
    none is a Z85 digit)."""
    try:
        return np.frombuffer(text.encode("ascii"), np.uint8)
    except UnicodeEncodeError:
        return np.minimum(np.frombuffer(text.encode("utf-32-le"), np.uint32), 255)


def z85_core_decode(text: str, nbytes: int) -> bytes:
    """Inverse of z85_core: decode exactly nbytes from its armored span.
    The first faulty group in text order decides the error, as in the
    original's group-by-group loop: a character outside the alphabet
    (the first of its group) or a value above 0xFFFFFFFF."""
    if len(text) != z85_core_len(nbytes):
        raise ValueError("bad z85 span length")
    values = _Z85_VALUE[_code_points(text)].reshape(-1, 5)
    bad_digit = values < 0
    bad_group = bad_digit.any(axis=1)
    groups = np.where(bad_digit, 0, values) @ np.asarray(_POW85, np.int64)
    faulty = np.flatnonzero(bad_group | (groups > 0xFFFFFFFF))
    if faulty.size:
        g = int(faulty[0])
        if bad_group[g]:
            c = text[5 * g + int(np.argmax(bad_digit[g]))]
            raise ValueError(f"bad z85 digit {c!r}")
        raise ValueError("z85 group overflow")
    return groups.astype(">u4").tobytes()[:nbytes]


def z85_armor(data: bytes) -> str:
    """Encode bytes as Z85 text (frame: 'DCZ:<len>\\n' body '\\n~\\n')."""
    body = z85_core(data)
    lines = [body[i : i + _LINE] for i in range(0, max(len(body), 1), _LINE)] or [""]
    return _Z85_MAGIC + ":" + str(len(data)) + "\n" + "\n".join(lines) + "\n~\n"


# --- Ascii85 armor (btoa/Adobe: chars '!'..'u', 'z' for a zero group) ---

_A85_MAGIC = "DCA"


def ascii85_armor(data: bytes) -> str:
    """Encode bytes as Ascii85 (frame: 'DCA:<len>\\n' body '\\n~\\n');
    all-zero 4-byte groups emit the classic 'z' shorthand."""
    pad = (-len(data)) % 4
    buf = data + b"\x00" * pad
    digits = []
    for i in range(0, len(buf), 4):
        v = int.from_bytes(buf[i : i + 4], "big")
        if v == 0:
            digits.append("z")
            continue
        for p in (85**4, 85**3, 85**2, 85, 1):
            digits.append(chr(33 + (v // p) % 85))
    body = "".join(digits)
    lines = [body[i : i + _LINE] for i in range(0, max(len(body), 1), _LINE)] or [""]
    return _A85_MAGIC + ":" + str(len(data)) + "\n" + "\n".join(lines) + "\n~\n"


def ascii85_dearmor(text: str) -> bytes:
    """Inverse of ascii85_armor (whitespace-tolerant)."""
    head, _, rest = text.partition("\n")
    if not head.startswith(_A85_MAGIC + ":"):
        raise ValueError("bad ascii85 armor header")
    nbytes = int(head[len(_A85_MAGIC) + 1 :])
    out = bytearray()
    group = 0
    ndig = 0
    for c in rest:
        if c in " \t\r\n":
            continue
        if c == "~":
            break
        if c == "z":
            if ndig:
                raise ValueError("'z' inside an ascii85 group")
            out += b"\x00\x00\x00\x00"
            continue
        if not ("!" <= c <= "u"):
            raise ValueError(f"not an ascii85 digit: {c!r}")
        group = group * 85 + (ord(c) - 33)
        ndig += 1
        if ndig == 5:
            out += group.to_bytes(4, "big")
            group = 0
            ndig = 0
    if ndig:
        raise ValueError("truncated ascii85 group")
    if len(out) < nbytes:
        raise ValueError("truncated armor")
    return bytes(out[:nbytes])


def z85_dearmor(text: str) -> bytes:
    """Inverse of z85_armor (whitespace-tolerant)."""
    head, _, rest = text.partition("\n")
    if not head.startswith(_Z85_MAGIC + ":"):
        raise ValueError("bad z85 armor header")
    nbytes = int(head[len(_Z85_MAGIC) + 1 :])
    out = bytearray()
    group = 0
    ndig = 0
    for c in rest:
        if c in " \t\r\n":
            continue
        if c == "~":
            break
        try:
            group = group * 85 + _Z85_DECODE[c]
        except KeyError:
            raise ValueError(f"not a z85 digit: {c!r}") from None
        ndig += 1
        if ndig == 5:
            out += group.to_bytes(4, "big")
            group = 0
            ndig = 0
    if ndig:
        raise ValueError("truncated z85 group")
    if len(out) < nbytes:
        raise ValueError("truncated armor")
    return bytes(out[:nbytes])
