"""Seeded synthetic corpora.

The generators down to ``GENERATORS`` use only integer arithmetic on
``np.random.PCG64(seed).random_raw`` (numpy keeps a bit generator's raw
stream fixed across versions), so the same seed gives the same bytes
everywhere: the golden wire hashes in ``tests/data/torch_golden.json``
rest on that.

The benchmark corpora after them are copies of the JAX package's
``utils/corpora.py``: the same ``np.random.default_rng`` calls, so the
same bytes as the JAX package's on the same numpy, but not across numpy
versions.  ``parallel.multihost.measure_encode_throughput`` reads
``synthetic_enwik``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

# enwik8-like alphabet (letters, space, punctuation, markup) with Zipf
# weights round(1e6 / rank**1.1), fixed here as integers.
ENWIK_ALPHABET = np.frombuffer(
    b" etaoinshrdlcumwfgypbvk'\"<>/=.,;:[]|()&#x1230984756-_\nqjzETAOINSHR",
    np.uint8,
)
ENWIK_WEIGHTS = np.array(
    [
        1000000, 466516, 298653, 217638, 170268, 139326, 117596, 101532,
        89194, 79433, 71527, 64998, 59520, 54860, 50851, 47366, 44310, 41610,
        39208, 37057, 35120, 33368, 31776, 30323, 28991, 27767, 26638, 25593,
        24624, 23723, 22882, 22097, 21362, 20672, 20023, 19412, 18836, 18291,
        17776, 17288, 16824, 16384, 15966, 15567, 15187, 14824, 14477, 14146,
        13829, 13525, 13233, 12954, 12685, 12427, 12179, 11940, 11709, 11488,
        11274, 11067, 10868, 10675, 10489, 10309, 10134, 9966,
    ],
    np.uint64,
)
assert ENWIK_WEIGHTS.size == ENWIK_ALPHABET.size


def _raw(seed: int, n: int) -> np.ndarray:
    return np.random.PCG64(seed).random_raw(n).astype(np.uint64)


def enwik_like(nbytes: int, seed: int) -> bytes:
    """``nbytes`` of text-like bytes: each byte draws from the fixed
    integer CDF of ENWIK_WEIGHTS with the top 32 bits of a raw draw."""
    cdf = np.cumsum(ENWIK_WEIGHTS)
    total = np.uint64(cdf[-1])  # < 2**22, so the product below fits 64 bits
    u = ((_raw(seed, nbytes) >> np.uint64(32)) * total) >> np.uint64(32)
    return ENWIK_ALPHABET[np.searchsorted(cdf, u, side="right")].tobytes()


def printable_like(nbytes: int, seed: int) -> bytes:
    """``enwik_like`` with its one non-printable byte, ``\\n``, made a
    space: every byte in 0x20-0x7E, so small_byte's ISPRINT mode takes
    every block."""
    return enwik_like(nbytes, seed).replace(b"\n", b" ")


def deep_code_block(size: int, seed: int) -> bytes:
    """One block whose n=2 Huffman code reaches the 15-digit cap:
    symbols 0..15 with Fibonacci frequencies, in a seeded order."""
    fib = [1, 1]
    for _ in range(14):
        fib.append(fib[-1] + fib[-2])
    w = np.array(fib, np.int64) * (size // sum(fib))
    w[-1] += size - w.sum()
    data = np.repeat(np.arange(len(w), dtype=np.uint8), w)
    order = np.argsort(_raw(seed, size), kind="stable")
    return data[order].tobytes()


def complete_lengths(arity: int, max_len: int, n_symbols: int) -> np.ndarray:
    """A Kraft-complete [256] int32 code-length row that reaches
    ``max_len`` digits: a chain with n-1 leaves at each depth below
    ``max_len`` and n at ``max_len``, then the shallowest leaf split into
    n until ``n_symbols`` symbols (0 .. n_symbols-1) are used.  A complete
    tree's last limit is exactly n**max_len; ``n_symbols`` must be
    1 + a multiple of n-1, at least the chain's."""
    n = arity
    lengths = [d for d in range(1, max_len) for _ in range(n - 1)] + [max_len] * n
    if n_symbols > 256 or n_symbols < len(lengths) or (n_symbols - 1) % (n - 1):
        raise ValueError(f"no complete {n}-ary tree of depth {max_len} with {n_symbols} leaves")
    while len(lengths) < n_symbols:
        d = min(lengths)
        lengths.remove(d)
        lengths += [d + 1] * n
    row = np.zeros(256, np.int32)
    row[:n_symbols] = sorted(lengths)
    return row


def long_small_blocks(size: int, seed: int) -> np.ndarray:
    """[3, size] uint8 blocks for the small codecs' lanes at long block
    sizes: one context only (bytes 0x01, 0x21, 0x41, 0x61, all & 31 == 1,
    so every insert but the first goes into context 1, whose slots the
    native encoders rewrite about size / 311 (scheme A) or size / 234
    (scheme B) times each), text, and text ending in 50
    copies of a sentence whose last byte, the 't' of "mat", has its top
    bit set: the dictionary holds that word's child by 't', so a search
    that folded letters to seven bits would extend the last word over the
    byte, where scheme A must refuse the block."""
    one = np.array([0x01, 0x21, 0x41, 0x61], np.uint8)[(_raw(seed, size) & 3).astype(np.intp)]
    text = np.frombuffer(enwik_like(size, seed), np.uint8)
    tail = np.frombuffer((b"the cat sat on the mat. " * 50)[:-2], np.uint8)
    high = text.copy()
    high[size - len(tail):] = tail
    high[-1] |= 0x80
    return np.stack([one, text, high])


def tight_span_payload(kind: str, S: int, seed: int) -> tuple:
    """(payload, raw length) of a crafted small_byte / small_nybble stream
    of the deepest words, each span's source ending exactly where the
    span is written.  Every symbol keeps one context (scheme A: bytes
    0x01, '!', 'A', 'a' at random, all & 31 == 1; scheme B: the nybble
    1), so the step-j insert lands in slot j - 2 of that context;
    literals and spans alternate, each span the entry the literal before
    it made (the span before + that literal), so the spans run 2, 3, 4,
    ... symbols long (past the encoders' match caps) until the block's
    S bytes are full; the raw length ends the last word."""
    nybble = kind == "small_nybble"
    rng = np.random.default_rng(seed)
    slots, first, N = (128, 2, 2 * S) if nybble else (127, 1, S)

    def literal():
        return 0x11 if nybble else int(rng.choice([0x01, 0x21, 0x41, 0x61]))

    idx = [literal(), literal()]
    total, step, span = first + 2, 2, 2
    while total + span + 1 <= N - 1:
        idx += [0x80 + (step - 2) % slots, literal()]
        total, step, span = total + span + 1, step + 2, span + 1
    if nybble and total % 2:
        idx.append(literal())
        total += 1
    return bytes([8, 0x11 if nybble else 0x61] + idx), total // 2 if nybble else total


def nybble_token_payload(S: int, seed: int, variant: int) -> tuple:
    """(payload, raw length) of a random nybble token stream for an
    S-byte block (S >= 5) that ends exactly at the body's end: packed
    tokens (one nybble, 8 | pos) and literals (two) at random, a first
    byte of any value.  ``variant`` 0: the raw length the stream decodes
    to; 1: one step more, past the body; 2 and 3: the body and one byte
    more, a packed token and then a literal's first nybble, at the raw
    length that ends on the packed token (2) or one more, whose literal
    would read its second nybble past the body (3)."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(1, S - 3))  # tokens
    nybbles = []
    for _ in range(m):
        if rng.random() < 0.6:
            nybbles.append(8 | int(rng.integers(0, 8)))
        else:
            nybbles += [int(rng.integers(0, 8)), int(rng.integers(0, 16))]
    if len(nybbles) % 2:  # end on a byte: one more packed token
        nybbles.append(8 | int(rng.integers(0, 8)))
        m += 1
    body = bytes((a << 4) | b for a, b in zip(nybbles[0::2], nybbles[1::2]))
    if variant >= 2:
        body += bytes([((8 | int(rng.integers(0, 8))) << 4) | int(rng.integers(0, 8))])
    payload = bytes([0xAF, int(rng.integers(0, 256))]) + body
    return payload, m + 1 + (variant != 0) + (variant == 3)


def payload_mix(kind: str, S: int, count: int, seed: int, real: bytes) -> tuple:
    """([payload], [raw length]) for the serial decoders on S-byte
    blocks, four kinds in turn: crafted streams (small_byte /
    small_nybble: ``tight_span_payload``'s deepest words, some cut one or
    two symbols short; nybble: ``nybble_token_payload``'s token streams
    ending at the body's end, with a raw length one step past it or a
    literal's second nybble past it), the real payload ``real`` of S
    bytes with 1-4 bytes flipped, the same cut short, and random bodies
    behind the type byte."""
    rng = np.random.default_rng(seed)
    type_byte = 0xAF if kind == "nybble" else 8
    payloads, raws = [], []
    for k in range(count):
        if k % 4 == 0:
            if kind == "nybble":
                p, n = nybble_token_payload(S, k, (k // 4) % 4)
            else:
                p, n = tight_span_payload(kind, S, k)
                n -= k % 3
        elif k % 4 == 1:
            b = bytearray(real)
            for j in rng.integers(2, len(b), int(rng.integers(1, 5))):
                b[j] = int(rng.integers(0, 256))
            p, n = bytes(b), S
        elif k % 4 == 2:
            p, n = real[: int(rng.integers(0, len(real)))], S
        else:
            body = rng.integers(0, 256, int(rng.integers(0, S + S // 8)), np.uint8).tobytes()
            p = bytes([type_byte]) + body
            n = int(rng.integers(1, S + 1))
        payloads.append(p)
        raws.append(n)
    return payloads, raws


# the generators by name, as the golden record names them
GENERATORS = {
    "enwik_like": enwik_like,
    "printable_like": printable_like,
    "deep_code_block": deep_code_block,
}


# ----------------------------------------------------------------------
# Benchmark corpora (copies of the JAX package's ``utils/corpora.py``)
# ----------------------------------------------------------------------

# Well-known local paths probed before synthesizing: the JAX package's,
# less its absolute spelling of the superuser's home directory
# (``~/corpora`` covers it there).
_SEARCH = ["/data", "/corpora", os.path.expanduser("~/corpora")]


def load_or_synthesize(name: str, nbytes: Optional[int] = None, seed: int = 0) -> bytes:
    """enwik6/enwik8/alice29.txt if present on disk, else synthetic."""
    for d in _SEARCH:
        p = os.path.join(d, name)
        if os.path.exists(p):
            with open(p, "rb") as f:
                data = f.read()
            return data[:nbytes] if nbytes else data
    sizes = {"enwik6": 10**6, "enwik8": 10**8, "alice29.txt": 152089}
    n = nbytes or sizes.get(name, 10**6)
    if name.startswith("enwik"):
        return synthetic_enwik(n, seed)
    return synthetic_english(n, seed)


def synthetic_enwik(nbytes: int, seed: int = 0) -> bytes:
    """enwik8-like: English text + wiki markup, ~4.2 bits/byte order-0
    entropy, zipf-weighted alphabet."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, ENWIK_ALPHABET.size + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    return rng.choice(ENWIK_ALPHABET, size=nbytes, p=probs).tobytes()


def synthetic_english(nbytes: int, seed: int = 0) -> bytes:
    """Word-structured English-like text (repeating word pool, so LZW
    codecs have real matches to find, unlike iid letters)."""
    rng = np.random.default_rng(seed)
    pool = (
        "the of and to in is was he that it his her you as had with for on at by "
        "but be this all from they which one said have will were me we when what "
        "would there been their time who more like into them could than other"
    ).split()
    words = rng.choice(np.asarray(pool, dtype=object), size=max(4, nbytes // 4))
    text = (" ".join(words)).encode()
    reps = -(-nbytes // len(text))
    return (text * reps)[:nbytes]


def repo_source_corpus(nbytes: Optional[int] = None) -> bytes:
    """Real, checked-in corpus: this repository's own source text (the
    port's package, ``tests/`` and ``tools/``) — the reference Makefile's
    trick of benchmarking on its own source (TEST_FILE_IN :=
    n_ary_huffman.c, Makefile:15), scaled up.  Deterministic: files
    concatenated in sorted path order, repeated to ``nbytes`` when
    requested."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.dirname(pkg)
    parts = []
    for base in (pkg, os.path.join(root, "tests"), os.path.join(root, "tools")):
        for dirpath, dirnames, filenames in sorted(os.walk(base)):
            dirnames.sort()
            for fn in sorted(filenames):
                if fn.endswith((".py", ".c", ".md")):
                    with open(os.path.join(dirpath, fn), "rb") as f:
                        parts.append(f.read())
    data = b"\n".join(parts)
    if not nbytes:
        return data
    reps = -(-nbytes // max(1, len(data)))
    return (data * reps)[:nbytes]


def mixed_corpus(nbytes: int, seed: int = 0) -> bytes:
    """Text+binary mix (the multi-host config in BASELINE.json)."""
    rng = np.random.default_rng(seed)
    third = nbytes // 3
    a = synthetic_enwik(third, seed)
    b = synthetic_english(third, seed + 1)
    c = rng.integers(0, 256, size=nbytes - 2 * third, dtype=np.uint8).tobytes()
    return a + b + c
