"""The serial codecs' lanes, one block per lane (kernels:
``csrc/nybble_lanes.cu``, ``csrc/small_lanes.cu``).

Replace the ``lax.scan`` lanes of ``data_compression_tpu/ops/scan_codecs.py``
(``_encode_lane`` / ``_decode_lane`` of nybble, ``_small_byte_*_lane``,
``_small_nybble_*_lane``), which reach no Pallas kernel.  Six wrappers,
one per kernel instantiation, each with its ``launches`` count:
``nybble_encode``, ``nybble_decode``, ``small_byte_encode``,
``small_byte_decode``, ``small_nybble_encode``, ``small_nybble_decode``.

Encode.  In: ``blocks`` [B, S] uint8, ``lengths`` [B] integers (valid
bytes of each row, clamped to 0..S).  Out: ``rows`` [B, row_width(kind,
S)] uint8, ``totals`` [B] int32, ``status`` [B] int32, on the blocks'
device.  ``rows[b, :totals[b]]`` is block b's payload, type byte first
(an empty block gives the lone type byte); ``totals[b]`` is 0 where
``status[b]`` is not OK.  Status INPUT: the block holds a byte >= 0x80
(nybble and small_byte, whose schemes are 7-bit).

Decode.  In: ``flat`` [F] uint8 (the payloads back to back), ``offsets``
[B] int64, ``plens`` [B] int32, ``raw_lens`` [B] int32 and the row width
``S`` (raw lengths are clamped to 0..S).  Out: ``out`` [B, S] uint8,
``status`` [B] int32; ``out[b, :raw_lens[b]]`` is block b where its
status is OK.  Status FORMAT: a wrong type byte, a payload too short, an
index past the dictionary or a word past the raw length, as the native
runtime's ``DCT_ERR_FORMAT``; a block of raw length 0 decodes to nothing
whatever its payload.  Rows of a block whose status is not OK hold
anything.

The wrappers launch the kernel for CUDA tensors (or raise) and take the
plain version for CPU tensors; they read nothing back and allocate only
their outputs.  The plain versions ``nybble_encode_ref``, ``nybble_decode_ref``,
``small_encode_ref`` and ``small_decode_ref`` are the JAX lanes written
out: the ``vmap`` is the batch dimension, the ``scan`` a Python loop of
steps on [B]-shaped int64 tensors on the inputs' device, the state the
JAX carries (the [B, 16, 8] move-to-front table; the [B, 32, slots]
dictionary), emissions placed at a running output count.  They run
on any device and are on no path where a card is present.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from data_compression_tpu_torch.config import DEFAULT_BLOCK_SIZE
from data_compression_tpu_torch.ops.kernels import _build

OK, INPUT, CAPACITY, FORMAT = 0, 1, 2, 3
MAX_BLOCK = 1 << 28  # longest block a lane takes (small decode: 32-bit positions)
NYBBLES_TYPE = 0xAF
EIGHT_BIT_PRUNED = 8
KINDS = ("nybble", "small_byte", "small_nybble")
_SEED_ROW = b" etaoins"  # nybble_compression.c:546-562
_CTX = 32


def row_width(kind: str, S: int) -> int:
    """Encode row width: the worst-case payload of an S-byte block."""
    if kind not in KINDS:
        raise ValueError(f"no serial lane for {kind!r}")
    if S == 0:
        return 1
    return {"nybble": S + 2, "small_byte": S + 1, "small_nybble": 2 * S}[kind]


def _check_encode(blocks, lengths):
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise ValueError(f"blocks must be [B, S] uint8, got {blocks.dtype} {tuple(blocks.shape)}")
    if lengths.shape != blocks.shape[:1] or lengths.is_floating_point():
        raise ValueError(f"lengths must be [{blocks.shape[0]}] integers")
    if blocks.shape[1] > MAX_BLOCK:
        raise ValueError(f"a serial lane takes blocks of at most {MAX_BLOCK} bytes")


def _check_decode(flat, offsets, plens, raw_lens, S):
    if flat.dtype != torch.uint8 or flat.dim() != 1:
        raise ValueError(f"flat must be [F] uint8, got {flat.dtype} {tuple(flat.shape)}")
    B = offsets.shape[0] if offsets.dim() == 1 else -1
    if offsets.dtype != torch.int64 or B < 0:
        raise ValueError("offsets must be [B] int64")
    for name, t in (("plens", plens), ("raw_lens", raw_lens)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be [{B}] int32")
    if not 0 <= S <= MAX_BLOCK:
        raise ValueError(f"a serial lane takes blocks of at most {MAX_BLOCK} bytes, got S={S}")
    return B


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _high_bytes(blocks, n):
    """[B] bool: a valid byte of the row is >= 0x80."""
    valid = torch.arange(blocks.shape[1], device=blocks.device)[None, :] < n[:, None]
    return ((blocks >= 0x80) & valid).any(1)


def _mtf_rows(row, byte, active):
    """Move-to-front of ``byte`` in each [8] row (update_context,
    nybble_compression.c:665-687), where ``active``."""
    eq = row == byte[:, None]
    pos = torch.where(eq.any(1), eq.to(torch.int8).argmax(1), 7)
    shifted = torch.cat((byte[:, None], row[:, :7]), 1)
    j = torch.arange(8, device=row.device)
    new = torch.where(j[None, :] <= pos[:, None], shifted, row)
    return torch.where(active[:, None], new, row)


def nybble_encode_ref(blocks, lengths):
    """Plain version of the nybble encode lane (``_encode_lane``).  The
    step updates its state, the step number included, in place
    (``_Steps``: a CUDA graph on the card)."""
    _check_encode(blocks, lengths)
    B, S = blocks.shape
    dev = blocks.device
    W = row_width("nybble", S)
    n = lengths.to(dev, torch.int64).clamp(0, S)
    out = torch.zeros((B, W + 1), dtype=torch.int64, device=dev)  # column W: trash
    out[:, 0] = NYBBLES_TYPE
    o = torch.full((B,), 2, dtype=torch.int64, device=dev)
    if S:
        ar = torch.arange(B, device=dev)
        src = blocks.to(torch.int64)
        out[:, 1] = src[:, 0]
        seed = torch.tensor(list(_SEED_ROW), dtype=torch.int64, device=dev)
        table = seed.repeat(B, 16, 1)
        pending = torch.full((B,), -1, dtype=torch.int64, device=dev)
        p = src[:, 0].clone()
        i = torch.ones(1, dtype=torch.int64, device=dev)  # the step's byte

        def step():
            active = i < n
            s = src.index_select(1, i)[:, 0]
            ctx = (p >> 3) & 15
            row = table[ar, ctx]
            eq = row == s[:, None]
            hit = eq.any(1)
            nyb = 8 | eq.to(torch.int8).argmax(1)
            half = pending >= 0
            # hit: nothing, or pending|nyb; miss: s, or p then s (re-expand)
            count = torch.where(hit, half.long(), torch.where(half, 2, 1)) * active
            b1 = torch.where(hit, (pending << 4) | nyb, torch.where(half, p, s))
            out[ar, torch.where(count >= 1, o, W)] = b1
            out[ar, torch.where(count == 2, o + 1, W)] = s
            o.add_(count)
            pending.copy_(torch.where(active, torch.where(hit & ~half, nyb, -1), pending))
            table[ar, ctx] = _mtf_rows(row, s, active)
            p.copy_(torch.where(active, s, p))
            i.add_(1)

        _Steps(step, dev).run(S - 1)
        flush = pending >= 0  # trailing odd nybble
        out[ar, torch.where(flush, o, W)] = p
        o += flush
    high = _high_bytes(blocks, n)
    totals = torch.where(n == 0, 1, torch.where(high, 0, o)).to(torch.int32)
    status = torch.where(high, INPUT, OK).to(torch.int32)
    return out[:, :W].to(torch.uint8), totals, status


def _payload_matrix(flat, offsets, plens, extra):
    """[B, max plen + extra] int64: each payload, zeros past its end."""
    P = int(plens.max()) if plens.numel() else 0
    cols = torch.arange(P + extra, device=flat.device)
    idx = offsets[:, None] + cols[None, :]
    inside = cols[None, :] < plens[:, None].long()
    if flat.numel() == 0:
        return torch.zeros(idx.shape, dtype=torch.int64, device=flat.device)
    vals = flat.to(torch.int64)[idx.clamp(0, flat.numel() - 1)]
    return torch.where(inside, vals, 0)


def _decode_start(flat, offsets, plens, raw_lens, S, type_byte):
    """-> (payload matrix, n, status, alive): raw length 0 is OK whatever
    the payload; else a payload under 2 bytes or a wrong type is FORMAT."""
    dev = flat.device
    pay = _payload_matrix(flat, offsets, plens, 3)
    n = raw_lens.to(dev, torch.int64).clamp(0, S)
    bad = (n > 0) & ((plens.long() < 2) | (pay[:, 0] != type_byte))
    status = torch.where(bad, FORMAT, OK).to(torch.int64)
    return pay, n, status, (n > 0) & ~bad


def nybble_decode_ref(flat, offsets, plens, raw_lens, S: int):
    """Plain version of the nybble decode lane (``_decode_lane``), with
    the native decoder's errors.  The step updates its state, the step
    number and the nybble cursor included, in place (``_Steps``: a CUDA
    graph on the card)."""
    B = _check_decode(flat, offsets, plens, raw_lens, S)
    dev = flat.device
    pay, n, status, alive = _decode_start(flat, offsets, plens, raw_lens, S, NYBBLES_TYPE)
    out = torch.zeros((B, S + 1), dtype=torch.int64, device=dev)  # column S: trash
    if S and B:
        ar = torch.arange(B, device=dev)
        P = pay.shape[1]
        dlen = plens.long() - 2
        out[:, 0] = pay[:, 1]
        prev = pay[:, 1].clone()
        seed = torch.tensor(list(_SEED_ROW), dtype=torch.int64, device=dev)
        table = seed.repeat(B, 16, 1)
        j = torch.zeros(B, dtype=torch.int64, device=dev)
        k = torch.ones(1, dtype=torch.int64, device=dev)  # the step's output byte

        def step():
            active = alive & (k < n)
            b0 = pay[ar, (2 + (j >> 1)).clamp(max=P - 1)]
            nyb = torch.where((j & 1) == 1, b0 & 15, b0 >> 4)
            packed = (nyb & 8) != 0
            j2 = j + 1
            b2 = pay[ar, (2 + (j2 >> 1)).clamp(max=P - 1)]
            nxt = torch.where((j2 & 1) == 1, b2 & 15, b2 >> 4)
            bad = active & (((j + (~packed).long()) >> 1) >= dlen)  # past the body
            status.copy_(torch.where(bad, FORMAT, status))
            alive.copy_(alive & ~bad)
            act = active & ~bad
            ctx = (prev >> 3) & 15
            row = table[ar, ctx]
            o = torch.where(packed, row.gather(1, (nyb & 7)[:, None])[:, 0],
                            ((nyb & 7) << 4) | nxt)
            table[ar, ctx] = _mtf_rows(row, o, act)
            out[ar, torch.where(act, k, S)] = o
            prev.copy_(torch.where(act, o, prev))
            j.copy_(torch.where(act, j + torch.where(packed, 1, 2), j))
            k.add_(1)

        _Steps(step, dev).run(S - 1)
    return out[:, :S].to(torch.uint8), status.to(torch.int32)


def _small_scheme(nybble: bool):
    """(slots per context, encoder match cap, symbols of the first byte)."""
    return (256, 511, 2) if nybble else (0x7F, 255, 1)


def _symbols(blocks, nybble):
    """[B, S] bytes, or [B, 2S] nybbles low first, as int64."""
    src = blocks.to(torch.int64)
    if not nybble:
        return src
    return torch.stack((src & 15, src >> 4), 2).reshape(src.shape[0], -1)


class _Steps:
    """``run(count)`` calls ``step`` ``count`` times.  On a CUDA device the
    first call runs on a side stream (the warm-up capture needs), then one
    call is captured in a CUDA graph, kept for later runs, and replayed: the
    step's few dozen launches go to the card as one.  ``step`` must keep
    its state in place, the step number included, and read nothing back."""

    def __init__(self, step, dev):
        self.step, self.dev, self.graph = step, dev, None

    def run(self, count: int) -> None:
        if count <= 0:
            return
        if self.dev.type != "cuda" or (count == 1 and self.graph is None):
            for _ in range(count):
                self.step()
            return
        if self.graph is None:
            main = torch.cuda.current_stream(self.dev)
            side = torch.cuda.Stream(self.dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self.step()
            main.wait_stream(side)
            count -= 1
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):  # records the step; runs nothing
                self.step()
        for _ in range(count):
            self.graph.replay()


def small_encode_ref(blocks, lengths, nybble: bool):
    """Plain version of ``_small_byte_encode_lane`` (``nybble`` False) or
    ``_small_nybble_encode_lane`` (True): one step per input symbol.  The
    dictionary is the JAX carry's prefix / letter / gen / prefix_gen /
    nwi; its starts and lengths are left out, as the search never reads
    them (a slot holds a span exactly when its gen is above 0).  The step
    updates its state, the step number included, in place (``_Steps``:
    a CUDA graph on the card)."""
    _check_encode(blocks, lengths)
    kind = "small_nybble" if nybble else "small_byte"
    B, S = blocks.shape
    dev = blocks.device
    NS, max_len, first = _small_scheme(nybble)
    W = row_width(kind, S)
    n = lengths.to(dev, torch.int64).clamp(0, S)
    N = 2 * n if nybble else n
    out = torch.zeros((B, W + 1), dtype=torch.int64, device=dev)  # column W: trash
    out[:, 0] = EIGHT_BIT_PRUNED
    o = torch.full((B,), 2, dtype=torch.int64, device=dev)
    if S:
        ar = torch.arange(B, device=dev)
        slots = torch.arange(NS, device=dev)
        src = blocks.to(torch.int64)
        sym = _symbols(blocks, nybble)
        out[:, 1] = src[:, 0]
        if nybble:
            prefix = ((slots & 15) | 0x10).repeat(B, _CTX, 1)
            letter = (slots >> 4).repeat(B, _CTX, 1)
            nwi = torch.full((B, _CTX), 0x80, dtype=torch.int64, device=dev)
            literal_slot = (slots | 15) == 0x1F
        else:
            prefix = torch.full((B, _CTX, NS), ord(" "), dtype=torch.int64, device=dev)
            letter = slots.repeat(B, _CTX, 1)
            letter[:, :, 0] = ord("x")
            nwi = torch.zeros((B, _CTX), dtype=torch.int64, device=dev)
            literal_slot = torch.zeros(NS, dtype=torch.bool, device=dev)
        gen = torch.zeros((B, _CTX, NS), dtype=torch.int64, device=dev)
        pgen = torch.zeros_like(gen)
        # the previous word: the verbatim first byte
        pctx = torch.full((B,), ord(" ") & 31, dtype=torch.int64, device=dev)
        pidx = torch.full((B,), -1, dtype=torch.int64, device=dev) if nybble else src[:, 0].clone()
        # the word in flight starts at symbol `first`
        c0 = sym[:, min(first, sym.shape[1] - 1)]
        index = c0 | 0x10 if nybble else c0.clone()
        ctx_c = src[:, 0] & 31
        banned = torch.where(ctx_c == pctx, nwi[ar, pctx], -1)
        mstart = torch.full((B,), first, dtype=torch.int64, device=dev)
        mlen = torch.ones(B, dtype=torch.int64, device=dev)
        i = torch.full((1,), first + 1, dtype=torch.int64, device=dev)  # the step's symbol

        def step():
            active = i < N
            c = sym.index_select(1, i)[:, 0]
            # extend the word with symbol c: the lowest slot holding it
            if nybble:
                lit_idx = (index | 15) == 0x1F
                want = torch.where(lit_idx, 0, gen[ar, ctx_c, index.clamp(0, NS - 1)])
                gen_ok = lit_idx[:, None] | (pgen[ar, ctx_c] == want[:, None])
            else:
                slot = index - 0x80
                want = gen[ar, ctx_c, slot.clamp(0, NS - 1)]
                gen_ok = (slot < 0)[:, None] | (pgen[ar, ctx_c] == want[:, None])
            ok = ((prefix[ar, ctx_c] == index[:, None]) & (letter[ar, ctx_c] == c[:, None])
                  & gen_ok & ~literal_slot & (slots[None, :] != banned[:, None]))
            w = ok.to(torch.int8).argmax(1)
            extend = active & ok.any(1) & (mlen < max_len)
            emit = active & ~extend
            # a miss emits the word and inserts the previous word + its first symbol
            out[ar, torch.where(emit, o, W)] = index
            o.add_(emit)
            s = nwi[ar, pctx]
            g = gen[ar, pctx, s] + 1
            gen[ar, pctx, s] = torch.where(emit, g, gen[ar, pctx, s])
            prefix[ar, pctx, s] = torch.where(emit, pidx, prefix[ar, pctx, s])
            if nybble:
                p_ok = (pidx >= 0) & ((pidx | 15) != 0x1F)
                pslot = pidx.clamp(0, NS - 1)
            else:
                p_ok = pidx >= 0x80
                pslot = (pidx - 0x80).clamp(0, NS - 1)
            pg = torch.where(p_ok, gen[ar, pctx, pslot], 0)
            pgen[ar, pctx, s] = torch.where(emit, pg, pgen[ar, pctx, s])
            letter[ar, pctx, s] = torch.where(emit, sym[ar, mstart], letter[ar, pctx, s])
            if nybble:
                nxt = torch.where(s + 1 >= 0x100, 0x80, s + 1)
            else:
                nxt = (s + 1) % NS
            nwi[ar, pctx] = torch.where(emit, nxt, s)
            pctx.copy_(torch.where(emit, ctx_c, pctx))
            pidx.copy_(torch.where(emit, index, pidx))
            # a new word starts at symbol i; its context is the byte before it
            new_ctx = src.index_select(1, (i >> 1) - 1 if nybble else i - 1)[:, 0] & 31
            new_banned = torch.where(new_ctx == pctx, nwi[ar, pctx], -1)
            banned.copy_(torch.where(emit, new_banned, banned))
            ctx_c.copy_(torch.where(emit, new_ctx, ctx_c))
            grown = w if nybble else 0x80 + w
            index.copy_(torch.where(emit, (c | 0x10) if nybble else c,
                                    torch.where(extend, grown, index)))
            mstart.copy_(torch.where(emit, i, mstart))
            mlen.copy_(torch.where(emit, 1, torch.where(extend, mlen + 1, mlen)))
            i.add_(1)

        _Steps(step, dev).run(sym.shape[1] - (first + 1))
        tail = N > first  # the word in flight
        out[ar, torch.where(tail, o, W)] = index
        o += tail
    bad = torch.zeros(B, dtype=torch.bool, device=dev) if nybble else _high_bytes(blocks, n)
    totals = torch.where(n == 0, 1, torch.where(bad, 0, o)).to(torch.int32)
    status = torch.where(bad, INPUT, OK).to(torch.int32)
    return out[:, :W].to(torch.uint8), totals, status


WINDOW_STEPS = 64  # plain small decode: steps between two reads of the longest entry


def small_decode_ref(flat, offsets, plens, raw_lens, S: int, nybble: bool):
    """Plain version of ``_small_byte_decode_lane`` (``nybble`` False) or
    ``_small_nybble_decode_lane`` (True): one step per payload index,
    with the native decoder's errors.  Spans are gathered then written:
    a span ends at most where its word is written (checked), so no copy
    reads its own output.  The gather is K symbols wide, fixed for
    WINDOW_STEPS steps: a word is at most the longest entry or the word
    before it (M, read back once), and each step's insert adds at most
    one symbol to that, so K = M + WINDOW_STEPS covers them; the steps
    update their state in place and run as replays of one CUDA graph a K
    on the card (``_Steps``)."""
    B = _check_decode(flat, offsets, plens, raw_lens, S)
    dev = flat.device
    NS, _, first = _small_scheme(nybble)
    pay, n, status, alive = _decode_start(flat, offsets, plens, raw_lens, S, EIGHT_BIT_PRUNED)
    target = 2 * n if nybble else n
    T = 2 * S if nybble else S
    buf = torch.zeros((B, T + 1), dtype=torch.int64, device=dev)  # symbols; column T: trash
    if S and B:
        ar = torch.arange(B, device=dev)
        p1 = pay[:, 1]
        if nybble:
            buf[:, 0], buf[:, 1] = p1 & 15, p1 >> 4
        else:
            buf[:, 0] = p1
        starts = torch.full((B, _CTX, NS), -1, dtype=torch.int64, device=dev)
        lengths = torch.zeros_like(starts)
        nwi = torch.full((B, _CTX), 0x80 if nybble else 0, dtype=torch.int64, device=dev)
        length = torch.full((B,), first, dtype=torch.int64, device=dev)  # symbols so far
        pctx = torch.full((B,), ord(" ") & 31, dtype=torch.int64, device=dev)
        ppos = torch.zeros(B, dtype=torch.int64, device=dev)
        plen = torch.full((B,), first, dtype=torch.int64, device=dev)
        pl = plens.long()
        i = torch.full((1,), 2, dtype=torch.int64, device=dev)  # the step's payload index

        def make_step(K):
            k = torch.arange(K, device=dev)

            def step():
                active = alive & (length < target) & (i < pl)
                idx = pay.index_select(1, i)[:, 0]
                if nybble:
                    done = length >> 1
                    last = (buf[ar, (2 * done - 2).clamp(0)]
                            | (buf[ar, (2 * done - 1).clamp(0)] << 4))
                    lit = (idx | 15) == 0x1F
                    slot = idx
                    no_slot = torch.zeros(B, dtype=torch.bool, device=dev)
                else:
                    last = buf[ar, (length - 1).clamp(0)]
                    lit = idx < 0x80
                    slot = idx - 0x80
                    no_slot = ~lit & (slot >= NS)  # 0xFF
                ctx = last & 31
                st = starts[ar, ctx, slot.clamp(0, NS - 1)]
                ln = lengths[ar, ctx, slot.clamp(0, NS - 1)]
                default = ~lit & (st < 0)
                span = ~lit & ~default
                wl = torch.where(lit, 1, torch.where(default, 2, ln))
                bad = active & (no_slot | (length + wl > target) | (span & (st + wl > length)))
                status.copy_(torch.where(bad, FORMAT, status))
                alive.copy_(alive & ~bad)
                act = active & ~bad
                if nybble:
                    d0, d1 = idx & 15, idx >> 4
                else:
                    d0 = torch.full_like(idx, ord(" "))
                    d1 = torch.where(slot == 0, ord("x"), slot)
                lit_sym = (idx & 15) if nybble else idx
                fixed = torch.where(lit[:, None], torch.where(k == 0, lit_sym[:, None], 0),
                                    torch.where(k == 0, d0[:, None], d1[:, None]))
                copied = buf.gather(1, (st.clamp(0)[:, None] + k[None, :]).clamp(max=T))
                word = torch.where(span[:, None], copied, fixed)
                dest = torch.where(act[:, None] & (k[None, :] < wl[:, None]),
                                   length[:, None] + k[None, :], T)
                buf.scatter_(1, dest, word)
                # insert the previous word + this word's first symbol into pctx
                s = nwi[ar, pctx]
                starts[ar, pctx, s] = torch.where(act, ppos, starts[ar, pctx, s])
                lengths[ar, pctx, s] = torch.where(act, plen + 1, lengths[ar, pctx, s])
                nxt = torch.where(s + 1 >= 0x100, 0x80, s + 1) if nybble else (s + 1) % NS
                nwi[ar, pctx] = torch.where(act, nxt, s)
                pctx.copy_(torch.where(act, ctx, pctx))
                ppos.copy_(torch.where(act, length, ppos))
                plen.copy_(torch.where(act, wl, plen))
                length.copy_(torch.where(act, length + wl, length))
                i.add_(1)

            return step

        runs = {}  # K -> _Steps
        left = pay.shape[1] - 5  # payload indexes 2 .. P - 4
        while left > 0:
            g = min(WINDOW_STEPS, left)
            M = int(torch.maximum(lengths.max(), plen.max()).clamp(min=2))
            K = -(-(M + g) // 32) * 32
            if K not in runs:
                runs[K] = _Steps(make_step(K), dev)
            runs[K].run(g)
            left -= g
        short = alive & (length < target)  # payload ran out first
        status = torch.where(short, FORMAT, status)
    if nybble:
        out = buf[:, 0:T:2] | (buf[:, 1:T:2] << 4)
    else:
        out = buf[:, :S]
    return out.to(torch.uint8), status.to(torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _encode(wrapper, kind, blocks, lengths):
    _check_encode(blocks, lengths)
    if blocks.device.type == "cpu":
        if kind == "nybble":
            return nybble_encode_ref(blocks, lengths)
        return small_encode_ref(blocks, lengths, kind == "small_nybble")
    blocks = blocks.contiguous()
    lengths = lengths.to(blocks.device, torch.int32).contiguous()
    _build.require_cuda(blocks, lengths)
    B, S = blocks.shape
    W = row_width(kind, S)
    rows = torch.empty((B, W), dtype=torch.uint8, device=blocks.device)
    totals = torch.empty(B, dtype=torch.int32, device=blocks.device)
    status = torch.empty(B, dtype=torch.int32, device=blocks.device)
    if B:
        lib = _build.lib()
        args = (blocks.data_ptr(), S, lengths.data_ptr(), rows.data_ptr(), W, totals.data_ptr(),
                status.data_ptr(), B, _build.stream_of(blocks))
        with torch.cuda.device(blocks.device):
            if kind == "nybble":
                rc = lib.dct_nybble_encode(*args)
            else:
                rc = lib.dct_small_encode(int(kind == "small_nybble"), *args)
        _build.check(rc, f"{kind} encode lane")
        wrapper.launches += 1
    return rows, totals, status


def _decode(wrapper, kind, flat, offsets, plens, raw_lens, S):
    B = _check_decode(flat, offsets, plens, raw_lens, S)
    if flat.device.type == "cpu":
        if kind == "nybble":
            return nybble_decode_ref(flat, offsets, plens, raw_lens, S)
        return small_decode_ref(flat, offsets, plens, raw_lens, S, kind == "small_nybble")
    _build.require_cuda(flat, offsets, plens, raw_lens)
    dev = flat.device
    out = torch.empty((B, S), dtype=torch.uint8, device=dev)
    status = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        lib = _build.lib()
        with torch.cuda.device(dev):
            if kind == "nybble":
                rc = lib.dct_nybble_decode(flat.data_ptr(), flat.numel(), offsets.data_ptr(),
                                           plens.data_ptr(), raw_lens.data_ptr(), out.data_ptr(),
                                           S, status.data_ptr(), B, _build.stream_of(flat))
            else:
                rc = lib.dct_small_decode(int(kind == "small_nybble"), flat.data_ptr(),
                                          flat.numel(), offsets.data_ptr(), plens.data_ptr(),
                                          raw_lens.data_ptr(), out.data_ptr(), S,
                                          status.data_ptr(), B, _build.stream_of(flat))
        _build.check(rc, f"{kind} decode lane")
        wrapper.launches += 1
    return out, status


def nybble_encode(blocks, lengths):
    """Nybble encode lane (``csrc/nybble_lanes.cu``) -> (rows, totals, status)."""
    return _encode(nybble_encode, "nybble", blocks, lengths)


def nybble_decode(flat, offsets, plens, raw_lens, S):
    """Nybble decode lane (``csrc/nybble_lanes.cu``) -> (out, status)."""
    return _decode(nybble_decode, "nybble", flat, offsets, plens, raw_lens, S)


def small_byte_encode(blocks, lengths):
    """Scheme-A encode lane (``small_encode_kernel<false>``) -> (rows, totals, status)."""
    return _encode(small_byte_encode, "small_byte", blocks, lengths)


def small_byte_decode(flat, offsets, plens, raw_lens, S):
    """Scheme-A decode lane (``small_decode_kernel<false, *>``) -> (out, status)."""
    return _decode(small_byte_decode, "small_byte", flat, offsets, plens, raw_lens, S)


def small_nybble_encode(blocks, lengths):
    """Scheme-B encode lane (``small_encode_kernel<true>``) -> (rows, totals, status)."""
    return _encode(small_nybble_encode, "small_nybble", blocks, lengths)


def small_nybble_decode(flat, offsets, plens, raw_lens, S):
    """Scheme-B decode lane (``small_decode_kernel<true, *>``) -> (out, status)."""
    return _decode(small_nybble_decode, "small_nybble", flat, offsets, plens, raw_lens, S)


def longest_context_chain(blocks: np.ndarray, lengths: np.ndarray) -> int:
    """The most steps of one context in any block: the nybble encoder's
    serial chain (step i's context is byte i - 1's bits 3-6), counted on
    the host from [B, S] uint8 blocks and their [B] lengths."""
    longest = 0
    for row, n in zip(blocks, lengths):
        if n > 1:
            ctx = (row[: n - 1] >> 3) & 15
            longest = max(longest, int(np.bincount(ctx, minlength=16).max()))
    return longest


def layout_text(threads_per_cta: int, blocks_per_cta: int, smem_per_cta: int) -> str:
    """A lane launch's block-to-thread mapping in words, from the numbers
    ``lane_occupancy`` reads off the kernel."""
    per_block = threads_per_cta // blocks_per_cta
    if threads_per_cta == 64 and blocks_per_cta > 1:
        who = f"a parse warp and a chain warp for {blocks_per_cta} blocks (one lane a chain)"
    else:
        who = ("a warp a block" if per_block == 32 else "a thread a block" if per_block == 1
               else f"{per_block // 32} warps a block" if per_block % 32 == 0
               else f"{per_block} threads a block")
    return (f"{who}, {blocks_per_cta} block(s) a CTA, "
            f"{smem_per_cta:,} B of shared memory a CTA")


def lane_occupancy(name: str, S: int = DEFAULT_BLOCK_SIZE) -> dict:
    """The launch of lane kernel ``name`` for blocks of ``S`` bytes on the
    current CUDA device (S picks a small decoder's dictionary layout):
    CTAs resident on one SM at once (the occupancy API at the launch's
    block size and shared memory), blocks a CTA, threads a CTA and shared
    bytes a CTA (static + dynamic), all from the CUDA source, and
    ``layout``, those in words.  A launch of B blocks runs in
    ceil(B / (ctas_per_sm x SMs x blocks_per_cta)) waves."""
    kind, direction = name.rsplit("_", 1)
    if kind not in KINDS or direction not in ("encode", "decode"):
        raise ValueError(f"no serial lane {name!r}")
    ctas, per_cta, threads, smem = (ctypes.c_int(0) for _ in range(4))
    out = [ctypes.byref(v) for v in (ctas, per_cta, threads, smem)]
    decode = int(direction == "decode")
    lib = _build.lib()
    if kind == "nybble":
        rc = lib.dct_nybble_occupancy(decode, *out)
    else:
        rc = lib.dct_small_occupancy(decode, int(kind == "small_nybble"), S, *out)
    _build.check(rc, f"{name} occupancy")
    return {"ctas_per_sm": ctas.value, "blocks_per_cta": per_cta.value,
            "threads_per_cta": threads.value, "smem_per_cta": smem.value,
            "layout": layout_text(threads.value, per_cta.value, smem.value)}


ENCODERS = {"nybble": nybble_encode, "small_byte": small_byte_encode,
            "small_nybble": small_nybble_encode}
DECODERS = {"nybble": nybble_decode, "small_byte": small_byte_decode,
            "small_nybble": small_nybble_decode}
for _fn in (*ENCODERS.values(), *DECODERS.values()):
    _fn.launches = 0
