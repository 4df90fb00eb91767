"""Seeded input buffers, made on the device.

A frozen copy of the program's ``utils/corpora.py`` enwik8-like integer
CDF (``ENWIK_ALPHABET``, ``ENWIK_WEIGHTS``) and of ``deep_code_block``
(16 symbols with Fibonacci frequencies, whose binary Huffman code reaches
the 15-digit cap), drawn with a ``torch.Generator`` on the buffers' device
so that set-up spends no time in numpy.  The same seed gives the same
bytes on the same device type; the bytes differ from the program's numpy
generators, which draw from another bit stream.
"""

from __future__ import annotations

import torch

ENWIK_ALPHABET = b" etaoinshrdlcumwfgypbvk'\"<>/=.,;:[]|()&#x1230984756-_\nqjzETAOINSHR"
ENWIK_WEIGHTS = (
    1000000, 466516, 298653, 217638, 170268, 139326, 117596, 101532,
    89194, 79433, 71527, 64998, 59520, 54860, 50851, 47366, 44310, 41610,
    39208, 37057, 35120, 33368, 31776, 30323, 28991, 27767, 26638, 25593,
    24624, 23723, 22882, 22097, 21362, 20672, 20023, 19412, 18836, 18291,
    17776, 17288, 16824, 16384, 15966, 15567, 15187, 14824, 14477, 14146,
    13829, 13525, 13233, 12954, 12685, 12427, 12179, 11940, 11709, 11488,
    11274, 11067, 10868, 10675, 10489, 10309, 10134, 9966,
)
DEEP_SYMBOLS = 16
_DRAW_STEP = 1 << 25  # symbols drawn per call: bounds the int32 temporaries to 128 MiB


def _fibonacci(count: int) -> list:
    fib = [1, 1]
    while len(fib) < count:
        fib.append(fib[-1] + fib[-2])
    return fib


def enwik_like(out: torch.Tensor, gen: torch.Generator) -> None:
    """Fill the uint8 tensor ``out`` with text-like bytes: each byte draws
    its symbol from the integer CDF of ENWIK_WEIGHTS."""
    dev = out.device
    weights = torch.tensor(ENWIK_WEIGHTS, dtype=torch.int32, device=dev)
    cdf = torch.cumsum(weights, 0, dtype=torch.int32)
    alphabet = torch.frombuffer(bytearray(ENWIK_ALPHABET), dtype=torch.uint8).to(dev)
    flat = out.view(-1)
    total = int(sum(ENWIK_WEIGHTS))
    for s in range(0, flat.numel(), _DRAW_STEP):
        n = min(_DRAW_STEP, flat.numel() - s)
        u = torch.randint(0, total, (n,), generator=gen, device=dev, dtype=torch.int32)
        idx = torch.searchsorted(cdf, u, right=True, out_int32=True)
        flat[s:s + n] = alphabet[idx]


def deep_code_block(out: torch.Tensor, gen: torch.Generator) -> None:
    """Fill the [S] uint8 tensor ``out`` with symbols 0..15 at Fibonacci
    frequencies (scaled to S, the rest on the last), in a seeded order."""
    S = out.numel()
    fib = _fibonacci(DEEP_SYMBOLS)
    w = [f * (S // sum(fib)) for f in fib]
    w[-1] += S - sum(w)
    counts = torch.tensor(w, dtype=torch.int64, device=out.device)
    symbols = torch.arange(DEEP_SYMBOLS, dtype=torch.uint8, device=out.device)
    data = torch.repeat_interleave(symbols, counts)
    out.copy_(data[torch.randperm(S, generator=gen, device=out.device)])


def make_buffers(corpus: dict, count: int, blocks: int, block_size: int, seed: int,
                 device) -> list:
    """``count`` distinct [blocks, block_size] uint8 buffers from ``seed``:
    enwik8-like text, and in every group of ``corpus["deep_block_every"]``
    blocks (the last group may be shorter) one deep-code block at a seeded
    position."""
    if corpus.get("text") != "enwik_like":
        raise ValueError(f"unknown corpus text {corpus.get('text')!r}")
    every = int(corpus["deep_block_every"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    buffers = []
    for _ in range(count):
        buf = torch.empty((blocks, block_size), dtype=torch.uint8, device=device)
        enwik_like(buf, gen)
        for g0 in range(0, blocks, every):
            span = min(every, blocks - g0)
            pos = g0 + int(torch.randint(0, span, (1,), generator=gen, device=device))
            deep_code_block(buf[pos], gen)
        buffers.append(buf)
    return buffers
