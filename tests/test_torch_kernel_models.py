"""Numpy models of the histogram and decode-table kernels'
decompositions (``csrc/histogram.cu``, ``csrc/decode_tables.cu``), run on
the CPU where the kernels cannot: the same per-thread work, addresses,
rounds, flushes and cluster sums, the same warp ranks and scans, with
the kernels' constants, held to numpy's counts and to the plain
versions.  They check the arithmetic and the layout claims (no counter
passes 255 between flushes, the 32 lanes of a warp hit 32 banks, the
16-bit pair sums do not carry); the kernels themselves are held to the
plain versions on the card (``tests/test_torch_cuda.py``).  Also the
geometry chooser ``slices_for`` at the main path's, the streamed
batch's and one-row shapes.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from data_compression_tpu_torch.api import DEFAULT_BATCH_BLOCKS
from data_compression_tpu_torch.config import ARITY_MAX_LEN
from data_compression_tpu_torch.ops import table_build as tbd
from data_compression_tpu_torch.ops.kernels import histogram as khist
from torch_cases import DECODE_ROW_KINDS, HIST_ROW_KINDS, decode_table_rows, hist_blocks

H100_SMS = 132
THREADS, VECS = 64, 16  # histogram.cu kThreads, kVecs
ROUND_VECS = THREADS * VECS
M64 = (1 << 64) - 1


def prmt(a, b, sel):
    """PTX ``prmt.b32`` (default mode) on uint32 arrays: nibble k of
    ``sel`` picks byte k of the result from the 8 bytes of (b, a); its
    bit 3 replicates the picked byte's sign instead."""
    a, b = np.asarray(a, np.uint64), np.asarray(b, np.uint64)
    src = [(a >> np.uint64(8 * k)) & np.uint64(0xFF) for k in range(4)]
    src += [(b >> np.uint64(8 * k)) & np.uint64(0xFF) for k in range(4)]
    out = np.zeros_like(a)
    for k in range(4):
        nib = (sel >> (4 * k)) & 0xF
        byte = src[nib & 7]
        if nib & 8:
            byte = np.where(byte & np.uint64(0x80), np.uint64(0xFF), np.uint64(0))
        out |= byte << np.uint64(8 * k)
    return out.astype(np.uint32)


SELECTORS = (0xCC40, 0xDD50, 0xEE60, 0xFF70)  # count_word's permutes, byte j = 0..3


def _model_cta(data, addr0, lo, hi):
    """One CTA of ``histogram_kernel`` on row bytes ``data[lo:hi]`` whose
    byte ``lo`` lies at address ``addr0``: -> its 256 sums."""
    extra = np.zeros(256, np.int64)
    head = min((16 - (addr0 & 15)) & 15, hi - lo)
    body = lo + head
    nvec = (hi - body) >> 4
    tail = body + 16 * nvec
    np.add.at(extra, data[lo:body], 1)
    np.add.at(extra, data[tail:hi], 1)
    sums = np.zeros(256, np.int64)
    tid = np.arange(THREADS)
    t4 = (tid.astype(np.uint32) << 2) * np.uint32(0x01010101)
    for r in range(0, nvec, ROUND_VECS):
        counters = np.zeros(256 * THREADS, np.int64)
        for k in range(VECS):
            i = r + k * THREADS + tid
            live = i < nvec
            vec = data[body + 16 * i[live, None] + np.arange(16)].reshape(-1, 4, 4)
            words = vec.astype(np.uint32) @ (np.uint32(1) << (8 * np.arange(4, dtype=np.uint32)))
            for w in range(4):
                hi_w = (words[:, w] >> np.uint32(2)) & np.uint32(0x3F3F3F3F)
                sh_w = (words[:, w] << np.uint32(3)) & np.uint32(0x18181818)
                for j, sel in enumerate(SELECTORS):
                    v = vec[:, w, j].astype(np.int64)
                    if k == VECS - 1 and w == 0 and j == 0:  # a thread's 256th byte of a round
                        np.add.at(extra, v, 1)
                        continue
                    at = prmt(t4[live], hi_w, sel).astype(np.int64)  # the counter word's byte address
                    inc = np.uint32(1) << ((sh_w >> np.uint32(8 * j)) & np.uint32(31))
                    assert np.array_equal(at, (v >> 2) * 256 + tid[live] * 4)
                    assert np.array_equal(inc, np.uint32(1) << (8 * (v & 3)).astype(np.uint32))
                    for warp in range(2):  # one instruction: 32 lanes, 32 banks
                        lanes = (tid[live] >> 5) == warp
                        banks = (at[lanes] >> 2) & 31
                        assert len(set(banks.tolist())) == int(lanes.sum())
                    np.add.at(counters, at + (v & 3), 1)
        assert counters.max(initial=0) <= 255, "a counter passed 255 within a round"
        words = counters.reshape(THREADS, 64, 4)  # [group t][thread][byte v & 3]
        even = words[:, :, 0] + (words[:, :, 2] << 16)
        odd = words[:, :, 1] + (words[:, :, 3] << 16)
        for q in range(16):  # the flush's 16-byte loads: 8 lanes of a phase, 8 bank quads
            for phase in range(0, THREADS, 8):
                quads = ((q + tid[phase:phase + 8]) & 15) & 7
                assert len(set(quads.tolist())) == 8
        e, o = even.sum(1), odd.sum(1)
        assert (words.sum(1) < 1 << 16).all()  # no carry between the 16-bit halves
        sums += np.stack([e & 0xFFFF, o & 0xFFFF, e >> 16, o >> 16], 1).reshape(-1)
    return sums + extra


def model_histograms(blocks, lengths, slices, offset=0):
    """``histogram_kernel`` on rows whose first byte lies ``offset``
    bytes past a 16-byte boundary, row stride S: -> [B, 256] counts."""
    B, S = blocks.shape
    span = ((S + slices - 1) // slices + 15) & ~15
    out = np.zeros((B, 256), np.int64)
    for row in range(B):
        n = min(max(int(lengths[row]), 0), S)
        for part in range(slices):  # a cluster: its first CTA adds the parts
            lo = min(part * span, n)
            hi = min(lo + span, n)
            out[row] += _model_cta(blocks[row], offset + row * S + lo, lo, hi)
    return out


def _bincounts(blocks, lengths):
    return np.stack([np.bincount(blocks[i, :lengths[i]], minlength=256)
                     for i in range(len(lengths))])


@pytest.mark.parametrize("B,S,want", [(1024, 65536, 1), (DEFAULT_BATCH_BLOCKS, 65536, 1),
                                      (1, 65536, 4), (1, 1 << 20, 8), (7, 65536, 4),
                                      (100, 65536, 2), (1, 4104, 1), (1, 32767, 1)])
def test_slices_for_fills_the_card(B, S, want):
    """The main path's 64 MiB (1,024 rows), the streamed batch (256
    rows) and one row: slices double while the CTAs are fewer than the
    SMs and each keeps a 16 KiB round."""
    got = khist.slices_for(B, S, H100_SMS)
    assert got == want
    assert got in (1, 2, 4, 8) and (got == 1 or S >= got * khist.MIN_SLICE)


@pytest.mark.parametrize("kind", ["edges", "full"])
@pytest.mark.parametrize("slices", [1, 2, 4])
@pytest.mark.parametrize("offset", [0, 3])
def test_histogram_model_matches_numpy(kind, slices, offset):
    """Rows of text, zeros, 255 and random bytes at every length edge, S
    a multiple of 16 and not, two rounds a row, as the card cuts them."""
    for S in (40000, 4104):
        blocks, lengths = hist_blocks(kind, 5, S, S + slices)
        got = model_histograms(blocks, lengths, slices, offset)
        assert np.array_equal(got, _bincounts(blocks, lengths))


@pytest.mark.parametrize("offset", [1, 15])
def test_histogram_model_partial_rounds_stay_under_the_flush_limit(offset):
    """Rows of one value at an odd offset: each 16 KiB slice has 1,023
    whole vectors, a round short of full in which all threads but one
    still count 16 vectors (256 bytes)."""
    blocks, lengths = hist_blocks("one_value", 2, 65536, 8)
    lengths[1] = 65536 - 100
    got = model_histograms(blocks, lengths, 4, offset)
    assert np.array_equal(got, _bincounts(blocks, lengths))


@pytest.mark.parametrize("kind", HIST_ROW_KINDS)
def test_histogram_model_crosses_the_flush_limit(kind):
    """One row of 1 MiB, 8 slices of 8 rounds: one value takes each
    thread's counter to 255 in every round, a period-16 record each of
    its bytes' counters to 16 or more."""
    S = 1 << 20
    blocks, lengths = hist_blocks(kind, 1, S, 5)
    assert khist.slices_for(1, S, H100_SMS) == 8
    got = model_histograms(blocks, lengths, 8)
    assert np.array_equal(got, _bincounts(blocks, lengths))


def _match_ranks(keys, count):
    """One slot of the warp: each lane's rank among the earlier symbols
    of its length; ``count`` advanced as the groups' first lanes do."""
    rank = np.empty(32, np.int64)
    for lane in range(32):
        same = np.flatnonzero(keys == keys[lane])
        rank[lane] = count[keys[lane]] + int((same < lane).sum())
    for key in set(keys.tolist()):
        count[key] += int((keys == key).sum())
    return rank


def model_decode_tables(rows, n, L):
    """``decode_tables_kernel``, one warp a row: -> (limit, bmf, symbols)."""
    B = rows.shape[0]
    limit = np.zeros((B, L + 1), np.int32)
    bmf = np.zeros((B, L + 1), np.int32)
    symbols = np.zeros((B, 256), np.int32)
    for b in range(B):
        lens = rows[b].astype(np.int64)
        count = np.zeros(256, np.int64)
        ranks = np.stack([_match_ranks(lens[32 * j:32 * j + 32], count) for j in range(8)])
        max_len = int(lens.max())
        own = [int(count[x]) if 1 <= x <= L else 0 for x in range(32)]
        c = count.copy()
        c[0] = 0
        base = np.concatenate([[0], np.cumsum(c)[:-1]])
        used = int(c.sum())
        sym = np.zeros(256, np.int64)
        for j in range(8):
            for i in range(32):
                if lens[32 * j + i] > 0:
                    sym[base[lens[32 * j + i]] + ranks[j, i]] = 32 * j + i
        symbols[b] = np.where(np.arange(256) < used, sym, 0)
        a = [n if x >= 1 else 1 for x in range(32)]
        g = list(own)
        d = 1
        while d < 32:  # the shuffles' inclusive scan, all lanes at once, mod 2**64
            pa, pg = list(a), list(g)
            for x in range(d, 32):
                g[x] = (a[x] * pg[x - d] + g[x]) & M64
                a[x] = (a[x] * pa[x - d]) & M64
            d <<= 1
        for x in range(L + 1):
            first = (n * g[x - 1 if x else 0]) & M64
            lim = (g[x] * a[L - x]) & M64 if x >= 1 and max_len >= 1 else 0
            bm = (int(base[x]) - first) & M64 if 1 <= x <= max_len else 0
            limit[b, x] = np.uint32(lim & 0xFFFFFFFF).view(np.int32)
            bmf[b, x] = np.uint32(bm & 0xFFFFFFFF).view(np.int32)
    return limit, bmf, symbols


@pytest.mark.parametrize("n", [2, 16, 3])
@pytest.mark.parametrize("kind", DECODE_ROW_KINDS)
def test_decode_table_model_matches_plain_version(kind, n):
    rows = decode_table_rows(kind, n, 9, 40 + n)
    got = model_decode_tables(rows, n, ARITY_MAX_LEN[n])
    want = tbd.decode_tables_device(torch.from_numpy(rows), n)
    for g, w, name in zip(got, want, ("limit", "bmf", "symbols")):
        assert np.array_equal(g, w.numpy()), name
