"""Decode kernel module: the plain version ``decode_chunks_ref`` against
the TPU kernel ``_decode_pallas`` (through ``decode_blocks_pallas`` in
Pallas interpret mode on the CPU), with the same tables carried across
by ``TableBatch.from_arrays`` and the same chunk payloads from the JAX
package's host encoder.  Tolerance: exact bytes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import data_compression_tpu.huffman.batched as jhb
from data_compression_tpu.models.huffman import encode_chunk_np

import data_compression_tpu_torch.huffman.batched as phb
from data_compression_tpu_torch.config import ARITY_MAX_LEN
from data_compression_tpu_torch.ops.kernels import decode as kdec
from data_compression_tpu_torch.utils.corpora import complete_lengths, deep_code_block, enwik_like


def _encoded(data, raw_lens, C):
    hists = np.stack(
        [np.bincount(data[b, : raw_lens[b]], minlength=256) for b in range(len(raw_lens))]
    ).astype(np.int64)
    tj = jhb.codes_batch(jhb.capped_lengths_batch(hists, 2), 2)
    chunks = []
    for b, n in enumerate(raw_lens):
        nc = max(1, -(-n // C))
        chunks.append([
            encode_chunk_np(data[b, c * C : c * C + max(0, min(C, n - c * C))], tj.table(b))
            for c in range(nc)
        ])
    return tj, chunks


def _port_decode(tj, chunks, raw_lens, C):
    tp = phb.TableBatch.from_arrays(dataclasses.asdict(tj))
    tabs = phb.to_device(tp, "cpu")
    flat = np.frombuffer(b"".join(c for blk in chunks for c in blk), np.uint8).copy()
    sizes = [len(c) for blk in chunks for c in blk]
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    cnt = [max(0, min(C, n - c * C)) for n, blk in zip(raw_lens, chunks) for c in range(len(blk))]
    blk = np.repeat(np.arange(len(chunks), dtype=np.int32), [len(b) for b in chunks])
    out = kdec.decode_chunks_ref(
        torch.from_numpy(flat), torch.from_numpy(off),
        torch.tensor(cnt, dtype=torch.int32), torch.from_numpy(blk),
        tabs["limit"], tabs["bmf"], tabs["symbols"], C,
    ).numpy()
    res, k = [], 0
    for n, b in zip(raw_lens, chunks):
        res.append(out[k : k + len(b)].reshape(-1)[:n].tobytes())
        k += len(b)
    return res


@pytest.mark.parametrize(
    "C,raw_lens",
    [(128, [128 * 128, 128 * 128 - 777]), (512, [3 * 512 + 321])],
    ids=["C128", "C512_partial_chunk"],
)
def test_decode_ref_matches_pallas_decode_kernel(C, raw_lens):
    from data_compression_tpu.ops.pallas.decode_kernel import LANES, decode_blocks_pallas

    S = C * LANES
    B = len(raw_lens)
    data = np.frombuffer(enwik_like(B * S, 30 + C), np.uint8).reshape(B, S).copy()
    for b, n in enumerate(raw_lens):
        data[b, n:] = 0
    tj, chunks = _encoded(data, raw_lens, C)
    want = decode_blocks_pallas(
        chunks, raw_lens, [tj.table(b) for b in range(B)], interpret=True,
        chunk_syms=C, arity=2,
    )
    got = _port_decode(tj, chunks, raw_lens, C)
    for b in range(B):
        assert got[b] == want[b], f"block {b}"
        assert got[b] == data[b, : raw_lens[b]].tobytes()


@pytest.mark.parametrize("case", ["deep_codes", "single_symbol", "empty_chunk", "tiny_chunks"])
def test_decode_ref_inverts_host_encoder(case):
    """15-digit codes, a one-symbol alphabet, an empty block (one chunk of
    zero symbols) and 16-symbol chunks decode exactly."""
    C = 512
    if case == "deep_codes":
        data = np.frombuffer(deep_code_block(65536, 6), np.uint8).reshape(1, -1).copy()
        raw_lens = [65536]
    elif case == "single_symbol":
        data = np.full((2, 1024), 97, np.uint8)
        raw_lens = [1024, 600]
    elif case == "empty_chunk":
        data = np.frombuffer(enwik_like(2048, 4), np.uint8).reshape(2, 1024).copy()
        raw_lens = [1024, 0]
    else:
        C = 16
        data = np.frombuffer(enwik_like(512, 5), np.uint8).reshape(2, 256).copy()
        raw_lens = [256, 37]
    for b, n in enumerate(raw_lens):
        data[b, n:] = 0
    tj, chunks = _encoded(data, raw_lens, C)
    if case == "deep_codes":
        assert int(tj.max_len[0]) == 15
    got = _port_decode(tj, chunks, raw_lens, C)
    for b, n in enumerate(raw_lens):
        assert got[b] == data[b, :n].tobytes(), f"block {b}"


def test_decode_ref_corrupt_stream_stays_in_bounds():
    """Random payload bytes with a real table: ranks clamp to 8 bits and
    reads stop at each chunk's end, so decode returns (wrong) bytes and
    never raises an indexing error."""
    rng = np.random.default_rng(2)
    data = np.frombuffer(enwik_like(2048, 12), np.uint8).reshape(1, -1).copy()
    tj, chunks = _encoded(data, [2048], 512)
    chunks = [[bytes(rng.integers(0, 256, len(c), dtype=np.uint8)) for c in chunks[0]]]
    got = _port_decode(tj, chunks, [2048], 512)
    assert len(got[0]) == 2048


def _lut_tables(source, n, rng):
    """(limit, bmf, symbols) int32 tensors of a few blocks: the port's
    tables of enwik-like and deep-code blocks, complete trees at the
    length cap, or seeded random nonnegative limits in [0, n**L]."""
    L = ARITY_MAX_LEN[n]
    if source == "random":
        B = 4
        limit = rng.integers(0, n**L + 1, (B, L + 1))
        limit[1] = np.sort(limit[1])  # one monotone row among the arbitrary ones
        bmf = rng.integers(-(1 << 20), 1 << 20, (B, L + 1))
        symbols = rng.integers(0, 256, (B, 256))
        return tuple(torch.from_numpy(a.astype(np.int32)) for a in (limit, bmf, symbols))
    if source == "real":
        data = np.frombuffer(enwik_like(65536, 40 + n) + deep_code_block(65536, 41), np.uint8)
        hists = np.stack([np.bincount(r, minlength=256) for r in data.reshape(2, -1)])
        lengths = phb.capped_lengths_batch(hists.astype(np.int64), n)
    else:
        lengths = np.stack([complete_lengths(n, L, s) for s in ((256, 129) if n == 2 else
                                                                (256, 241) if n == 16 else (255, 33))])
    tabs = phb.decode_tensors(phb.codes_batch(lengths, n), "cpu")
    return tabs["limit"], tabs["bmf"], tabs["symbols"]


@pytest.mark.parametrize("source", ["real", "complete", "random"])
@pytest.mark.parametrize("n", [2, 16, 3])
def test_decode_lut_entries_match_compare_chain(n, source):
    """Every entry of the kernel's K-digit table that is not the marker
    gives the compare chain's (ln, rank, symbol) for every window W of
    its prefix: all 2**15 windows at n = 2, a seeded sample plus both ends
    of every prefix at n = 16 and 3.  On canonical tables the entry is a
    marker exactly where the code is longer than K digits."""
    rng = np.random.default_rng(50 + n)
    limit, bmf, symbols = _lut_tables(source, n, rng)
    L, K = ARITY_MAX_LEN[n], kdec.LUT_DIGITS[n]
    lut = kdec.decode_lut_ref(limit, bmf, symbols, n)
    span = n ** (L - K)
    assert lut.shape == (limit.shape[0], n**K)
    if n == 2:
        W = torch.arange(n**L, dtype=torch.int64)
    else:
        ends = torch.arange(n**K, dtype=torch.int64) * span
        W = torch.cat([ends, ends + span - 1,
                       torch.from_numpy(rng.integers(0, n**L, 200_000))])
    lim = limit.to(torch.int64)
    ln = 1 + (W[None, :, None] >= lim[:, None, 1:L]).sum(-1)  # [B, |W|]
    rank = (torch.gather(bmf.to(torch.int64), 1, ln) + W[None, :] // n ** (L - ln)) & 0xFF
    sym = torch.gather(symbols.to(torch.int64), 1, rank) & 0xFF
    e = lut[:, W // span]
    hit = e != 0
    assert torch.equal((e >> 16 & 0xF)[hit], ln[hit])
    assert torch.equal((e >> 8 & 0xFF)[hit], rank[hit])
    assert torch.equal((e & 0xFF)[hit], sym[hit])
    assert torch.equal((e >> 20)[hit], (W[None, :] // n ** (L - ln))[hit])
    if source != "random":
        assert torch.equal(hit, ln <= K)
    assert bool(hit.any())


def test_decode_wrapper_cpu_dispatch_and_checks():
    z32 = torch.zeros((1, 16), dtype=torch.int32)
    sym = torch.zeros((1, 256), dtype=torch.int32)
    args = dict(flat=torch.zeros(0, dtype=torch.uint8),
                chunk_off=torch.zeros(2, dtype=torch.int64),
                chunk_cnt=torch.tensor([5], dtype=torch.int32),
                chunk_blk=torch.zeros(1, dtype=torch.int32),
                limit=z32, bmf=z32, symbols=sym, chunk_syms=16)
    before = kdec.decode_chunks.launches
    out = kdec.decode_chunks(**args)
    assert kdec.decode_chunks.launches == before
    assert out.shape == (1, 16) and out.dtype == torch.uint8
    with pytest.raises(ValueError):
        kdec.decode_chunks(**{**args, "chunk_off": torch.zeros(3, dtype=torch.int64)})
    with pytest.raises(ValueError):
        kdec.decode_chunks(**{**args, "limit": z32[:, :15]})
    with pytest.raises(ValueError):
        kdec.decode_chunks(**{**args, "chunk_syms": 24})
