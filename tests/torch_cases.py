"""Inputs and checks shared by the port's CPU and card tests (no JAX
here: the card tests import this module on a machine without it)."""

import numpy as np

from data_compression_tpu_torch.utils.corpora import enwik_like


HIST_ROW_KINDS = ("period16", "one_value")


def hist_blocks(kind, B, S, seed):
    """([B, S] uint8 blocks, [B] int64 lengths) of one histogram case:
    rows of text, all zeros, all 255 and random bytes in turn, the lengths
    S, 0, 1, S - 1 and random in turn ("edges"), or full ("full"); or
    full rows of one random 16-byte record repeated ("period16": every
    thread of the kernel loads the same vector) or of one random byte
    value ("one_value": from S = 1 MiB at B = 1 every counter the kernel
    keeps reaches its flush limit)."""
    rng = np.random.default_rng(seed)
    if kind in HIST_ROW_KINDS:
        width = 16 if kind == "period16" else 1
        rec = rng.integers(0, 256, width, dtype=np.uint8)
        return np.tile(rec, (B, -(-S // width)))[:, :S].copy(), np.full(B, S, np.int64)
    text = np.frombuffer(enwik_like(S, seed), np.uint8)
    rows = [text, np.zeros(S, np.uint8), np.full(S, 255, np.uint8),
            rng.integers(0, 256, S, dtype=np.uint8)]
    blocks = np.stack([rows[i % 4] for i in range(B)])
    if kind == "full":
        return blocks, np.full(B, S, np.int64)
    picks = [S, 0, 1, S - 1]
    lengths = np.array([picks[i % 5] if i % 5 < 4 else int(rng.integers(0, S + 1))
                        for i in range(B)], np.int64)
    return blocks, lengths


DECODE_ROW_KINDS = ("real", "complete", "empty", "one_symbol", "random", "never_written")


def decode_table_rows(kind, arity, B, seed):
    """[B, 256] uint8 wire length rows of one decode-table case, or of
    every case in turn (``kind`` "mixed"): the capped code lengths of
    text blocks, the last one a deep-code block ("real"); a complete
    tree at the length cap L ("complete"); no symbol ("empty"); one
    symbol of length 1 ("one_symbol"); random lengths 0..L, mostly
    over-full ("random"); and rows the encoder never writes
    ("never_written"): lengths above L among random ones, every symbol
    of length 1 (an over-full tree whose sums pass 2**32 at n = 16) and
    every symbol of length 255."""
    from data_compression_tpu_torch.config import ARITY_MAX_LEN
    from data_compression_tpu_torch.huffman import batched as hb
    from data_compression_tpu_torch.utils.corpora import complete_lengths, deep_code_block

    L = ARITY_MAX_LEN[arity]
    rng = np.random.default_rng(seed)
    if kind == "mixed":
        parts = [decode_table_rows(k, arity, B, seed + i) for i, k in enumerate(DECODE_ROW_KINDS)]
        return np.stack([parts[i % len(parts)][i] for i in range(B)]) if B else parts[0]
    if kind == "real":
        size = 4096
        text = np.frombuffer(enwik_like(size * max(B - 1, 0), seed)
                             + deep_code_block(size, seed), np.uint8)
        blocks = text[-B * size:].reshape(B, size) if B else text[:0].reshape(0, size)
        hists = np.stack([np.bincount(b, minlength=256) for b in blocks]) if B else np.zeros(
            (0, 256), np.int64)
        rows = hb.capped_lengths_batch(hists.astype(np.int64), arity)
    elif kind == "complete":
        rows = np.tile(complete_lengths(arity, L, 256 if arity != 3 else 255), (B, 1))
        for r in rows:
            rng.shuffle(r)
    elif kind == "empty":
        rows = np.zeros((B, 256), np.int64)
    elif kind == "one_symbol":
        rows = np.zeros((B, 256), np.int64)
        rows[np.arange(B), rng.integers(0, 256, B)] = 1
    elif kind == "random":
        rows = rng.integers(0, L + 1, (B, 256))
    elif kind == "never_written":
        rows = rng.integers(0, L + 1, (B, 256))
        rows[:, rng.integers(0, 256, 9)] = rng.integers(L + 1, 256, 9)
        rows[1::3] = 1
        rows[2::3] = 255
    else:
        raise ValueError(f"unknown decode-table case {kind!r}")
    return np.asarray(rows).astype(np.uint8)


LANE_KINDS = ("nybble", "small_byte", "small_nybble")


def lane_blocks(kind, S, seed, B=None):
    """([B, S] uint8 blocks, [B] int64 lengths) for the serial lanes, one
    row of each: a repeated sentence; dictionary slot wrap (small_nybble:
    bytes 1-15, else 1-23); lengths 0, 1 and 2; text of length S - 37; a
    first word in the context of ' ' (the banned-slot rule); one byte
    value (the deepest words, each ending where the next is written);
    bytes 0-255 (raw for nybble and small_byte); 7-bit random bytes.
    With ``B``, the rows repeat in turn, each from its own seed."""
    if B is not None:
        parts = [lane_blocks(kind, S, seed + 1000 * k) for k in range(-(-B // 10))]
        blocks = np.concatenate([p[0] for p in parts])[:B]
        return blocks, np.concatenate([p[1] for p in parts])[:B]
    rng = np.random.default_rng(seed)
    text = enwik_like(max(S, 1), seed)
    rows = [
        b"the cat sat on the mat. " * (S // 24 + 1),
        bytes(rng.integers(1, 16 if kind == "small_nybble" else 24, S, dtype=np.uint8)),
        b"",
        text[:1],
        text[:2],
        text[: max(S - 37, 0)],
        b" " + text,
        b"a" * S,
        bytes(rng.integers(0, 256, S, dtype=np.uint8)),
        bytes(rng.integers(0, 128, S, dtype=np.uint8)),
    ]
    blocks = np.zeros((len(rows), S), np.uint8)
    lengths = np.zeros(len(rows), np.int64)
    for i, r in enumerate(rows):
        r = r[:S]
        blocks[i, : len(r)] = np.frombuffer(r, np.uint8)
        lengths[i] = len(r)
    return blocks, lengths


def decoded_as_native(kind, payloads, raws, out, status):
    """A serial decoder's ``out`` rows and ``status`` (one a payload)
    against the native decoder block by block: FORMAT where the native
    decoder raises, else OK and its bytes; -> the number of OK blocks."""
    from data_compression_tpu_torch import native
    from data_compression_tpu_torch.ops.kernels import serial_lanes as lanes

    out, status = out.cpu().numpy(), status.cpu().tolist()
    ok = 0
    for i, (p, n) in enumerate(zip(payloads, raws)):
        try:
            want = getattr(native, f"{kind}_decode")(p, n)
        except ValueError:
            want = None
        assert status[i] == (lanes.FORMAT if want is None else lanes.OK), i
        if want is not None:
            assert out[i, :n].tobytes() == want, i
            ok += 1
    return ok
