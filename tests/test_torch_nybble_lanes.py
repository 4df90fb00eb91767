"""The nybble lanes' decomposition (``csrc/nybble_lanes.cu``) as a numpy
model, held against the native runtime (``native.nybble_encode`` /
``nybble_decode``) and the plain lanes.

Encode: per-context move-to-front chains over a tile's steps, then the
rows of 32 steps: the pending-nybble state from the last miss before a
step, the bytes a step emits and their offsets by prefix counts, the
trailing flush.  Decode: the token starts of a tile's body by composing
the two-state automaton's per-byte functions, one record a step, the
first step whose token would read past the body (FORMAT), and the chain
over the records a tile behind the parse.  The model runs at a small tile so that rows, tiles and
their carries all occur on a few KiB.

Inputs are made with numpy from a seed.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from data_compression_tpu_torch import native
from data_compression_tpu_torch.ops.kernels import serial_lanes as lanes
from data_compression_tpu_torch.utils.corpora import (
    deep_code_block,
    enwik_like,
    nybble_token_payload,
    payload_mix,
)
from torch_cases import lane_blocks

SEED_ROW = list(b" etaoins")
TYPE = 0xAF
TILE = 96  # model tile: three encode rows of 32 steps (the kernels take 4096)


def _mtf(row, v):
    """Move-to-front of v in the row; -> its position before, or -1."""
    pos = row.index(v) if v in row else -1
    del row[pos if pos >= 0 else 7]
    row.insert(0, v)
    return pos


def model_encode(raw: bytes, tile: int = TILE) -> bytes:
    """The encode kernel's decomposition on one block (7-bit bytes)."""
    src = list(raw)
    n = len(src)
    if n == 0:
        return bytes([TYPE])
    out = [TYPE, src[0]]
    rows = [list(SEED_ROW) for _ in range(16)]  # one chain per context
    p, pcode, half = src[0], 0, 0
    for t0 in range(1, n, tile):
        steps = src[t0: t0 + tile]
        ctx = [((src[t0 + i - 1]) >> 3) & 15 for i in range(len(steps))]
        # buckets: each context's steps in order, walked as one chain
        code = [0] * len(steps)
        for c in range(16):
            for i in (i for i in range(len(steps)) if ctx[i] == c):
                pos = _mtf(rows[c], steps[i])
                code[i] = 8 | pos if pos >= 0 else 0
        # emit, rows of 32 steps
        for r in range(0, len(steps), 32):
            cs, ss = code[r: r + 32], steps[r: r + 32]
            cps, sps = [pcode] + cs[:-1], [p] + ss[:-1]
            hits = [bool(c & 8) for c in cs]
            emitted = []
            hs = []
            for lane, (c, s, cp, sp, hit) in enumerate(zip(cs, ss, cps, sps, hits)):
                misses = [m for m in range(lane) if not hits[m]]
                h = ((lane - 1 - misses[-1]) & 1) if misses else half ^ (lane & 1)
                hs.append(h)
                if hit:
                    emitted += [(cp << 4) | c] if h else []
                else:
                    emitted += [sp, s] if h else [s]
            # the row's bytes sit at the prefix counts of misses and halves
            assert len(emitted) == sum(1 for x in hits if not x) + sum(hs)
            out += emitted
            half = int(hits[-1] and not hs[-1])
            pcode, p = cs[-1], ss[-1]
    if half:
        out.append(p)
    return bytes(out)


IDENTITY = (0, 1, 0, 0)  # a run of no bytes: (state after from 0, from 1, tokens from 0, from 1)


def _byte_run(v):
    """One body byte as the automaton reads it (state 0: a token starts at
    its high nybble; 1: the high nybble is a literal's second half)."""
    ph, pl = v >> 7, (v >> 3) & 1
    return (ph & (pl ^ 1), pl ^ 1, 1 + ph, 1)


def _then(a, b):
    """Run a, then run b."""
    return (b[a[0]], b[a[1]], a[2] + b[2 + a[0]], a[3] + b[2 + a[1]])


def _parse(chunk: bytes, nxt: int, carry: int, end: bool, lanes=32, per=4):
    """A tile's records as the kernel makes them: rows of ``lanes`` x
    ``per`` bytes, each lane's run composed, a scan across the lanes,
    each lane's tokens at the scan's count; a literal on the body's last
    nybble dropped.  -> (records, the state after the tile)."""
    recs, c = [], carry
    for r in range(0, len(chunk), lanes * per):
        runs = []
        for lane in range(lanes):
            run = IDENTITY
            for v in chunk[r + per * lane: r + per * lane + per]:
                run = _then(run, _byte_run(v))
            runs.append(run)
        excl, made = IDENTITY, len(recs)
        for lane in range(lanes):
            seg = chunk[r + per * lane: r + per * lane + per]
            s = excl[c]
            assert made + excl[2 + c] == len(recs)  # the scan's count: where the lane writes
            for x, v in enumerate(seg):
                q = r + per * lane + x
                nb = chunk[q + 1] if q + 1 < len(chunk) else nxt
                hi, lo = v >> 4, v & 15
                if s == 0:
                    recs.append(0x80 | (hi & 7) if hi & 8 else ((hi & 7) << 4) | lo)
                if s == 1 or hi & 8:
                    recs.append(0x80 | (lo & 7) if lo & 8 else ((lo & 7) << 4) | (nb >> 4))
                s = _byte_run(v)[s]
            excl = _then(excl, runs[lane])
        c = excl[c]
    if end and c == 1:
        recs.pop()  # its second nybble would lie past the body
    return recs, c


def model_decode(payload: bytes, n: int, tile: int = TILE, lanes: int = 32):
    """The decode kernel's decomposition on one block, in its two warps'
    order: the parse makes tile t's records, their count and FORMAT from
    the payload alone, while the chain walks tile t - 1's; -> (bytes or
    None on FORMAT, the step at which FORMAT is found)."""
    if n == 0:
        return b"", None
    if len(payload) < 2 or payload[0] != TYPE:
        return None, 1
    out = [payload[1]]
    body = payload[2:]
    dlen = len(body)
    table = [list(SEED_ROW) for _ in range(16)]
    prev = payload[1] & 0x7F

    def chain(recs):
        nonlocal prev
        for t in recs:
            row = table[(prev >> 3) & 15]
            o = row[t & 7] if t & 0x80 else t
            _mtf(row, o)
            out.append(o)
            prev = o

    base, k, carry, behind = 0, 1, 0, []
    while k < n:
        if base >= dlen:
            return None, k
        ln = min(tile, dlen - base)
        nxt = body[base + ln] if base + ln < dlen else 0
        recs, carry = _parse(body[base: base + ln], nxt, carry, base + ln >= dlen, lanes)
        recs = recs[: n - k]
        chain(behind)  # the chain, a tile behind the parse
        behind = recs
        base, k = base + ln, k + len(recs)
    chain(behind)
    return bytes(out), None


def _native_decode(payload, n):
    try:
        return native.nybble_decode(payload, n)
    except ValueError:
        return None


def _encode_inputs():
    blocks, lengths = lane_blocks("nybble", 700, 71)
    raws = [blocks[i, : lengths[i]].tobytes() for i in range(len(lengths))]
    rng = np.random.default_rng(72)
    raws += [deep_code_block(2048, 73), b"a" * 700, bytes([0x7F]) * 97,
             rng.integers(0, 128, 1500, dtype=np.uint8).tobytes(),
             bytes(rng.integers(8, 16, 900, dtype=np.uint8)),  # one context (1)
             enwik_like(3000, 74)]
    return [r for r in raws if not r or max(r) < 0x80]


@pytest.mark.parametrize("tile", [32, TILE, 4096])
def test_encode_model_equals_the_native_encoder(tile):
    """Per-context chains, the pending-nybble scan and the prefix offsets
    give the native encoder's payload on every 7-bit input, at a tile of
    one row, of three and the kernel's."""
    for raw in _encode_inputs():
        assert model_encode(raw, tile) == native.nybble_encode(raw), (len(raw), raw[:16])


def test_encode_rows_fit_n_plus_two():
    """A step emits two bytes only after a step that emitted none, so a
    payload is at most n + 1 bytes, inside the n + 2 the kernel's row
    must hold (checked up front, as the C's per-step check); the n + 1
    is reached."""
    worst = 0
    for raw in _encode_inputs():
        worst = max(worst, len(model_encode(raw)) - len(raw))
    assert worst == 1


def _decode_inputs():
    """(payload, raw length): real payloads at their raw length and one
    step past it, each cut, flipped; crafted token streams ending at the
    body's end, a literal's second nybble just past the body; random
    bodies; the payload mix of the card tests."""
    cases = []
    rng = np.random.default_rng(75)
    for raw in _encode_inputs():
        p = native.nybble_encode(raw)
        cases += [(p, len(raw)), (p, len(raw) + 1), (p[: max(len(p) - 3, 0)], len(raw))]
        if len(p) > 2:
            b = bytearray(p)
            b[int(rng.integers(2, len(b)))] ^= int(rng.integers(1, 256))
            cases.append((bytes(b), len(raw)))
    for seed in range(24):
        cases.append(nybble_token_payload(300, seed, seed % 4))
    for _ in range(24):
        body = rng.integers(0, 256, int(rng.integers(0, 200)), dtype=np.uint8).tobytes()
        cases.append((bytes([TYPE, int(rng.integers(0, 256))]) + body, int(rng.integers(0, 400))))
    cases += [(b"", 0), (b"", 5), (b"\xaf", 3), (b"\x00\x41", 3), (b"\xaf\x41", 1), (b"\xaf\x41", 2)]
    real = native.nybble_encode(enwik_like(800, 76))
    payloads, raws = payload_mix("nybble", 800, 32, 77, real)
    return cases + list(zip(payloads, raws))


@pytest.mark.parametrize("tile,lanes", [(32, 2), (TILE, 4), (4096, 32), (2048, 32)])
def test_decode_model_equals_the_native_decoder(tile, lanes):
    """The token-start scan and the chain over records, a tile behind it,
    at a tile of one row, of a few and of the kernel's 2048, decode what
    the native decoder decodes and refuse what it refuses; the step at which
    the model finds FORMAT is the one at which the C returns it: the
    native decoder takes the same payload at that raw length and refuses
    it one step later."""
    formats = 0
    for payload, n in _decode_inputs():
        got, step = model_decode(payload, n, tile, lanes)
        want = _native_decode(payload, n)
        assert got == want, (payload[:8], n)
        if got is None:
            formats += 1
            if len(payload) >= 2 and payload[0] == TYPE:
                assert _native_decode(payload, step) is not None, (payload[:8], n, step)
                assert _native_decode(payload, step + 1) is None
    assert formats > 10


def test_crafted_token_streams_end_where_they_say():
    """``nybble_token_payload``: variants 0 and 2 decode, 1 and 3 are
    FORMAT; variant 3's last token is a literal whose second nybble lies
    just past the body."""
    for seed in range(12):
        for variant in range(4):
            p, n = nybble_token_payload(64, seed, variant)
            assert n <= 64
            assert (_native_decode(p, n) is None) == (variant in (1, 3))
            if variant == 3:
                assert p[-1] >> 7 and not p[-1] & 8  # a packed token, a literal's first nybble


def test_plain_lanes_on_the_decomposition_inputs():
    """The plain lanes (the wrappers on CPU tensors) agree with the
    model's inputs: encode rows equal the native payloads, decode
    statuses and OK rows the native decoder's."""
    raws = _encode_inputs()[:6]
    S = max(len(r) for r in raws)
    blocks = np.zeros((len(raws), S), np.uint8)
    for i, r in enumerate(raws):
        blocks[i, : len(r)] = np.frombuffer(r, np.uint8)
    lengths = np.array([len(r) for r in raws])
    rows, totals, status = lanes.nybble_encode(torch.from_numpy(blocks), torch.from_numpy(lengths))
    assert status.tolist() == [lanes.OK] * len(raws)
    for i, r in enumerate(raws):
        assert rows[i, : int(totals[i])].numpy().tobytes() == native.nybble_encode(r)
    cases = [c for c in _decode_inputs() if c[1] <= 300][:40]
    payloads, raw_lens = [p for p, _ in cases], [n for _, n in cases]
    plens = np.array([len(p) for p in payloads], np.int64)
    offsets = np.concatenate([[0], np.cumsum(plens)[:-1]]).astype(np.int64)
    flat = torch.from_numpy(np.frombuffer(b"".join(payloads), np.uint8).copy())
    out, st = lanes.nybble_decode(flat, torch.from_numpy(offsets),
                                  torch.from_numpy(plens.astype(np.int32)),
                                  torch.tensor(raw_lens, dtype=torch.int32), max(raw_lens))
    for i, (p, n) in enumerate(cases):
        want = _native_decode(p, n)
        assert int(st[i]) == (lanes.FORMAT if want is None else lanes.OK), i
        if want is not None:
            assert out[i, :n].numpy().tobytes() == want, i


def test_longest_context_chain_counts_the_encoders_serial_steps():
    """``serial_lanes.longest_context_chain``: the most steps of
    one context (step i's context: byte i - 1's bits 3-6) in any block,
    within each block's length; the deep-code block's chain is nearly the
    whole block."""
    rng = np.random.default_rng(78)
    blocks = rng.integers(0, 128, (4, 300), dtype=np.uint8)
    blocks[1, :] = 8  # every step in context 1
    lengths = np.array([300, 200, 1, 0])
    want = 0
    for row, n in zip(blocks, lengths):
        counts = [0] * 16
        for i in range(1, n):
            counts[(row[i - 1] >> 3) & 15] += 1
        want = max(want, max(counts))
    assert lanes.longest_context_chain(blocks, lengths) == want == 199
    deep = np.frombuffer(deep_code_block(65536, 7), np.uint8)[None, :]
    assert lanes.longest_context_chain(deep, np.array([65536])) > 0.97 * 65535


def _byte_perm(x, y, s):
    """CUDA's ``__byte_perm``: result byte k is byte (s >> 4k) & 7 of the
    eight bytes of y:x."""
    pool = (y << 32) | x
    return sum(((pool >> (8 * ((s >> (4 * k)) & 7))) & 0xFF) << (8 * k) for k in range(4))


def _mtf_words(lo, hi, v):
    """The kernels' move-to-front on a row held in two 32-bit words
    (``csrc/nybble_lanes.cu`` ``mtf``), in 32-bit arithmetic; -> (lo, hi,
    the step's code)."""
    u32 = 0xFFFFFFFF
    splat = (v * 0x01010101) & u32
    xl, xh = lo ^ splat, hi ^ splat
    zl = ~(xl + 0x7F7F7F7F) & 0x80808080 & u32
    zh = ~(xh + 0x7F7F7F7F) & 0x80808080 & u32
    z = (zh << 32) | zl
    m = z ^ ((z - 1) & 0xFFFFFFFFFFFFFFFF)
    ml, mh = m & u32, m >> 32
    sl, sh = _byte_perm(v, lo, 0x6540), _byte_perm(lo, hi, 0x6543)
    code = ((((zl >> 7) | (zh >> 3)) * 0x8C9DAEBF) & u32) >> 28
    return (lo & ~ml & u32) | (sl & ml), (hi & ~mh & u32) | (sh & mh), code


def test_row_arithmetic_matches_the_list_model():
    """The kernels' two-word move-to-front (a zero-byte test of the row
    XOR the byte's splat, the prefix mask from the match's lowest bit, a
    merge with the row shifted by two ``__byte_perm``) and the code made
    from the match bits by a multiply give the list model's row and (hit,
    pos) code on
    every position and on misses, for rows of distinct 7-bit bytes."""
    rng = np.random.default_rng(79)
    for _ in range(400):
        row = [int(x) for x in rng.permutation(128)[:8]]
        v = row[int(rng.integers(0, 8))] if rng.random() < 0.7 else int(rng.integers(0, 128))
        lo = sum(b << (8 * k) for k, b in enumerate(row[:4]))
        hi = sum(b << (8 * k) for k, b in enumerate(row[4:]))
        want = list(row)
        pos = _mtf(want, v)
        nlo, nhi, code = _mtf_words(lo, hi, v)
        got = [(nlo >> (8 * k)) & 0xFF for k in range(4)] + [(nhi >> (8 * k)) & 0xFF for k in range(4)]
        assert got == want, (row, v)
        assert code == (8 | pos if pos >= 0 else 0)


def test_layout_words_for_a_warp_of_blocks():
    """A decode CTA of two warps for two blocks (one warp parsing each
    block's tile in turn, one lane of the other a block's chain) is named
    so, not as a warp a block; two warps for one block stay so named."""
    assert lanes.layout_text(64, 2, 20976) == (
        "a parse warp and a chain warp for 2 blocks (one lane a chain), 2 block(s) a CTA, "
        "20,976 B of shared memory a CTA")
    assert lanes.layout_text(64, 1, 27696).startswith("2 warps a block, 1 block(s) a CTA")
