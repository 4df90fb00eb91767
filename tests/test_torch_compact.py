"""Compact kernel module: the plain version ``compact_blocks_ref``
against the TPU kernel ``compact_block_rows`` (Pallas interpret mode on
the CPU) fed the same rows.  The TPU kernel places blocks at 4 KiB-aligned
starts and the port at tight ones, so each block's valid slice is
compared.  Then the compress path's host bookkeeping (the payload total
it hands the compaction) against the JAX package at n = 2, 16 and 3, and
the wrapper's ``total`` and the launcher on the CPU.  Tolerance: exact
bytes.
"""

import numpy as np
import pytest
import torch

from data_compression_tpu_torch import CodecConfig, framing
from data_compression_tpu_torch.config import (
    ARITY_DIGITS_PER_BYTE,
    ARITY_MAX_LEN,
    max_chunk_bytes,
    wire_bytes,
)
from data_compression_tpu_torch.huffman import batched as hb
from data_compression_tpu_torch.models.huffman import HuffmanCodec
from data_compression_tpu_torch.ops.kernels import compact as kcmp
from data_compression_tpu_torch.ops.kernels import encode as kenc
from data_compression_tpu_torch.utils.corpora import complete_lengths, deep_code_block, enwik_like


def test_compact_ref_matches_pallas_compact_block_rows():
    import jax.numpy as jnp

    from data_compression_tpu.ops.pallas.compact_kernel import ALIGN, compact_block_rows

    rng = np.random.default_rng(17)
    B, NW = 4, 2 * ALIGN  # int32 words per row
    rows_w = rng.integers(-(2**31), 2**31, size=(B, NW), dtype=np.int64).astype(np.int32)
    block_bytes = np.array([5000, 0, 8192, 1], np.int64)
    padded_w = -(-block_bytes // 4096) * ALIGN
    starts_w = np.concatenate([[0], np.cumsum(padded_w)[:-1]]).astype(np.int32)
    out_cap_w = int(padded_w.sum())
    j_flat = np.asarray(
        compact_block_rows(jnp.asarray(rows_w), jnp.asarray(starts_w), out_cap_w,
                           interpret=True)
    ).view(np.uint8)

    rows = torch.from_numpy(rows_w.view(np.uint8).reshape(B, -1).copy())
    flat = kcmp.compact_blocks_ref(rows, torch.from_numpy(block_bytes.astype(np.int32)))
    flat = flat.numpy()
    assert flat.shape == (int(block_bytes.sum()),)
    tight = np.concatenate([[0], np.cumsum(block_bytes)])
    for b in range(B):
        n = int(block_bytes[b])
        got = flat[tight[b] : tight[b] + n]
        want = j_flat[starts_w[b] * 4 : starts_w[b] * 4 + n]
        assert got.tobytes() == want.tobytes(), f"block {b}"
        assert got.tobytes() == rows[b, :n].numpy().tobytes()


def test_compact_wrapper_cpu_dispatch_and_checks():
    rows = torch.arange(24, dtype=torch.uint8).reshape(3, 8)
    bb = torch.tensor([2, 0, 3], dtype=torch.int32)
    before = kcmp.compact_blocks.launches
    assert kcmp.compact_blocks(rows, bb).tolist() == [0, 1, 16, 17, 18]
    assert kcmp.compact_blocks.launches == before
    empty = kcmp.compact_blocks(rows[:0], bb[:0])
    assert empty.dtype == torch.uint8 and empty.numel() == 0
    with pytest.raises(ValueError):
        kcmp.compact_blocks(rows, bb.long())
    with pytest.raises(ValueError):
        kcmp.compact_blocks(rows.int(), bb)


# ---- the compress path's total, from the chunk digit counts

ARITIES = [2, 16, 3]


def _encode_case(n):
    """Four 4 KiB blocks at C = 512 (the last short) with the port's
    tables; block 2 is the deep-code block, coded at n = 3 and 16 by a
    complete tree at the length cap, its chunk 0 made of L-digit symbols
    (its wire bytes fill max_chunk_bytes)."""
    S, C, L = 4096, 512, ARITY_MAX_LEN[n]
    codec = HuffmanCodec(CodecConfig(arity=n, block_size=S, chunk_syms=C), "cpu")
    data = enwik_like(2 * S, 81) + deep_code_block(S, 82) + enwik_like(1000, 83)
    blocks, lengths = framing.split_blocks(data, S)
    dev_blocks, dev_lens = codec.upload_blocks(blocks, lengths)
    tb, _ = codec.tables(dev_blocks, dev_lens)
    if n != 2:
        lens = tb.lengths.copy()
        lens[2] = complete_lengths(n, L, 256 if n == 16 else 255)
        tb = hb.codes_batch(lens, n)
    deep = np.flatnonzero(tb.lengths[2] == L)
    blocks[2, :C] = deep[np.arange(C) % deep.size]
    return blocks, lengths, tb, C


@pytest.mark.parametrize("n", ARITIES)
def test_total_from_digits_matches_jax_bookkeeping(n):
    """The total the compress path hands the compaction, the wire bytes
    of the chunk digit counts, equals ``block_bytes.sum()`` of the plain
    encode, the JAX host encoder's chunk bytes chunk by chunk, and is
    within the JAX codec's capacity bound from the histograms
    (``data_compression_tpu/models/huffman.py:498-499``)."""
    import data_compression_tpu.huffman.batched as jhb
    from data_compression_tpu.models.huffman import encode_chunk_np

    blocks, lengths, tb, C = _encode_case(n)
    B, S = blocks.shape
    dense = hb.encode_tensors(tb, "cpu")["dense"]
    lens_t = torch.from_numpy(lengths.astype(np.int32))
    rows, digits, bb = kenc.encode_blocks_ref(torch.from_numpy(blocks), lens_t, dense, C, n)
    nb = wire_bytes(digits.numpy().astype(np.int64), n)
    total = int(nb.sum())
    assert total == int(bb.long().sum())
    assert int(nb.max()) == max_chunk_bytes(C, n)

    jt = jhb.codes_batch(tb.lengths, n)
    want = np.zeros_like(nb)
    for b in range(B):
        for c in range(S // C):
            syms = blocks[b, c * C : min(int(lengths[b]), (c + 1) * C)]
            want[b, c] = len(encode_chunk_np(syms, jt.table(b))) if syms.size else 0
    np.testing.assert_array_equal(nb, want)

    hists = np.stack([np.bincount(blocks[b, : int(lengths[b])], minlength=256) for b in range(B)])
    block_digits = (hists * jt.lengths.astype(np.int64)).sum(axis=1)
    bound = int((-(-block_digits // ARITY_DIGITS_PER_BYTE[n])).sum()) + B * (S // C)
    assert total <= bound

    flat = kcmp.compact_blocks(rows, bb, total=total)
    assert torch.equal(flat, kcmp.compact_blocks_ref(rows, bb)) and flat.numel() == total


@pytest.mark.parametrize("n", ARITIES)
def test_compress_path_hands_the_compaction_its_total(n, monkeypatch):
    """``HuffmanCodec.encode_blocks`` passes the compaction the exact
    payload total, so on the card it makes no host read of its own."""
    blocks, lengths, _, C = _encode_case(n)
    codec = HuffmanCodec(CodecConfig(arity=n, block_size=blocks.shape[1], chunk_syms=C), "cpu")
    seen = []

    def spy(rows, block_bytes, total=None):
        seen.append((total, int(block_bytes.long().sum())))
        return kcmp.compact_blocks_ref(rows, block_bytes)

    monkeypatch.setattr(kcmp, "compact_blocks", spy)
    result = codec.encode_blocks(blocks, lengths)
    assert len(seen) == 1 and seen[0][0] == seen[0][1] > 0
    monkeypatch.undo()
    assert result.payloads == codec.encode_blocks(blocks, lengths).payloads


# ---- the total argument and the launcher on the CPU

def _small():
    return torch.arange(24, dtype=torch.uint8).reshape(3, 8), torch.tensor([2, 0, 3], dtype=torch.int32)


def test_compact_total_and_launcher_on_cpu():
    rows, bb = _small()
    before = kcmp.compact_blocks.launches
    want = [0, 1, 16, 17, 18]
    assert kcmp.compact_blocks(rows, bb, total=5).tolist() == want
    assert kcmp.compact_blocks(rows, bb, total=np.int64(5)).tolist() == want
    out = torch.full((5,), 7, dtype=torch.uint8)
    assert kcmp.compact_launcher(rows, bb)(out) is out and out.tolist() == want
    assert kcmp.compact_launcher(rows, bb, total=5)().tolist() == want
    assert kcmp.compact_launcher(rows[:0], bb[:0], total=0)().numel() == 0
    assert kcmp.compact_blocks.launches == before


@pytest.mark.parametrize("bad", [4, 6, -1, 2.5, "5"])
def test_compact_rejects_a_wrong_total_on_cpu(bad):
    rows, bb = _small()
    with pytest.raises(ValueError):
        kcmp.compact_blocks(rows, bb, total=bad)


@pytest.mark.parametrize("shape,dtype,step", [((4,), torch.uint8, 1), ((5,), torch.int32, 1),
                                              ((5, 1), torch.uint8, 1), ((10,), torch.uint8, 2)])
def test_compact_launcher_rejects_a_wrong_out_on_cpu(shape, dtype, step):
    rows, bb = _small()
    out = torch.zeros(shape, dtype=dtype)[::step]
    with pytest.raises(ValueError):
        kcmp.compact_launcher(rows, bb)(out)
