"""Seeded synthetic corpora whose bytes do not depend on library versions.

Only integer arithmetic on ``np.random.PCG64(seed).random_raw`` is used
(numpy keeps a bit generator's raw stream fixed across versions), so the
same seed gives the same bytes everywhere: the golden wire hashes in
``tests/data/torch_golden.json`` rest on that.
"""

from __future__ import annotations

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


# the generators by name, as the golden record names them
GENERATORS = {
    "enwik_like": enwik_like,
    "printable_like": printable_like,
    "deep_code_block": deep_code_block,
}
