"""Per-chunk-rows encode: the plain version ``encode_chunk_rows_ref``
against the TPU kernel ``_encode_pallas`` (through
``encode_blocks_pallas`` in Pallas interpret mode on the CPU) and against
the JAX package's per-chunk host encoder, with the same tables carried
across by ``TableBatch.from_arrays``.

Tolerance: exact — equal digit counts and equal valid bytes of every
row (bytes past ceil(digits / 8) are undefined in both and not compared).
"""

import dataclasses

import numpy as np
import pytest
import torch

import data_compression_tpu.huffman.batched as jhb
from data_compression_tpu.models.huffman import encode_chunk_np

import data_compression_tpu_torch.huffman.batched as phb
from data_compression_tpu_torch.config import max_chunk_bytes
from data_compression_tpu_torch.ops.kernels import encode as kenc
from data_compression_tpu_torch.utils.corpora import deep_code_block, enwik_like


def _tables(data, raw_lens):
    hists = np.stack(
        [np.bincount(data[i, : raw_lens[i]], minlength=256) for i in range(len(raw_lens))]
    ).astype(np.int64)
    tj = jhb.codes_batch(jhb.capped_lengths_batch(hists, 2), 2)
    return tj, phb.TableBatch.from_arrays(dataclasses.asdict(tj))


def _rows(data, raw_lens, tp, C):
    dense = phb.to_device(tp, "cpu")["dense"]
    rows, digits = kenc.encode_chunk_rows_ref(
        torch.from_numpy(data), torch.from_numpy(raw_lens.astype(np.int32)), dense, C
    )
    return rows.numpy(), digits.numpy()


def _fill_deep_chunk(data, tj, b, C):
    """Chunk 0 of block b made of its table's 15-digit symbols only, so
    the chunk fills all max_chunk_bytes(C, 2) bytes of its row."""
    deep = np.flatnonzero(tj.lengths[b] == 15)
    assert deep.size, "fixture lost its depth"
    data[b, :C] = deep[np.arange(C) % deep.size]


def test_rows_ref_matches_pallas_rows_kernel():
    """C=128 (16 KiB blocks), B=3: a full block, a short block and a
    deep-code block whose first chunk is all 15-digit codes."""
    from data_compression_tpu.ops.pallas.encode_kernel import LANES, encode_blocks_pallas

    C = 128
    S = C * LANES
    data = np.frombuffer(enwik_like(2 * S, 31) + deep_code_block(S, 32), np.uint8)
    data = data.reshape(3, S).copy()
    raw_lens = np.array([S, S - 3 * C - 7, S], np.int64)
    data[1, raw_lens[1]:] = 0
    tj, tp = _tables(data, raw_lens)
    _fill_deep_chunk(data, tj, 2, C)  # after the tables: the kernel takes any table

    j_rows, j_nbytes, j_digits = encode_blocks_pallas(
        data, raw_lens, [tj.table(b) for b in range(3)], 2, interpret=True
    )
    j_rows, j_nbytes = np.asarray(j_rows), np.asarray(j_nbytes)
    rows, digits = _rows(data, raw_lens, tp, C)
    mb = max_chunk_bytes(C, 2)
    assert rows.shape == (3 * LANES, mb)
    np.testing.assert_array_equal(digits, np.asarray(j_digits))
    nbytes = (digits + 7) // 8
    np.testing.assert_array_equal(nbytes, j_nbytes)
    assert nbytes[2 * LANES] == mb, "the deep chunk must fill its row"
    assert (digits[2 * LANES - 3 : 2 * LANES] == 0).all()  # past the short block's end
    for r in range(3 * LANES):
        n = int(nbytes[r])
        assert rows[r, :n].tobytes() == j_rows[r, :n].tobytes(), f"row {r}"


@pytest.mark.parametrize("S,C", [(8192, 1024), (4096, 512), (4096, 16)])
def test_rows_ref_matches_host_encoder(S, C):
    """Each row equals the JAX host encoder's chunk payload, including
    geometries the Pallas kernel does not take (8 KiB / 1024), a partial
    last chunk, an empty chunk and a chunk of 15-digit codes."""
    data = np.frombuffer(enwik_like(2 * S, 33) + deep_code_block(S, 34), np.uint8)
    data = data.reshape(3, S).copy()
    raw_lens = np.array([S, C + 77, S], np.int64)
    data[1, raw_lens[1]:] = 0
    tj, tp = _tables(data, raw_lens)
    _fill_deep_chunk(data, tj, 2, C)
    rows, digits = _rows(data, raw_lens, tp, C)
    ncb = S // C
    assert rows.shape == (3 * ncb, max_chunk_bytes(C, 2))
    for b in range(3):
        for c in range(ncb):
            cnt = max(0, min(C, int(raw_lens[b]) - c * C))
            want = encode_chunk_np(data[b, c * C : c * C + cnt], tj.table(b))
            r = b * ncb + c
            assert (int(digits[r]) + 7) // 8 == len(want)
            assert rows[r, : len(want)].tobytes() == want, f"block {b} chunk {c}"
    assert digits[2 * ncb] == 15 * C


def test_rows_ref_agrees_with_compact_layout():
    """The valid bytes of a block's rows, in chunk order, are the block
    payload of ``encode_blocks_ref``."""
    S, C = 4096, 256
    data = np.frombuffer(enwik_like(3 * S, 35), np.uint8).reshape(3, S).copy()
    raw_lens = np.array([S, 1000, 1], np.int64)
    for b, n in enumerate(raw_lens):
        data[b, n:] = 0
    _, tp = _tables(data, raw_lens)
    rows, digits = _rows(data, raw_lens, tp, C)
    dense = phb.to_device(tp, "cpu")["dense"]
    crow, cdig, cbytes = kenc.encode_blocks_ref(
        torch.from_numpy(data), torch.from_numpy(raw_lens.astype(np.int32)), dense, C
    )
    ncb = S // C
    np.testing.assert_array_equal(digits.reshape(3, ncb), cdig.numpy())
    for b in range(3):
        got = b"".join(
            rows[b * ncb + c, : (int(digits[b * ncb + c]) + 7) // 8].tobytes()
            for c in range(ncb)
        )
        assert got == crow[b, : int(cbytes[b])].numpy().tobytes()


def test_rows_wrapper_cpu_dispatch_and_checks():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; malformed inputs raise ValueError."""
    data = torch.zeros((1, 256), dtype=torch.uint8)
    lens = torch.tensor([200], dtype=torch.int32)
    dense = torch.zeros((1, 256), dtype=torch.int32)
    dense[0, 0] = 1 << 15  # symbol 0: one digit, code 0
    before = kenc.encode_chunk_rows.launches
    rows, digits = kenc.encode_chunk_rows(data, lens, dense, 128)
    assert kenc.encode_chunk_rows.launches == before
    assert rows.shape == (2, max_chunk_bytes(128, 2))
    assert digits.tolist() == [128, 72]
    assert not rows[0, :16].any() and not rows[1, :9].any()
    with pytest.raises(ValueError):
        kenc.encode_chunk_rows(data, lens, dense, 96)  # not a power of two
    with pytest.raises(ValueError):
        kenc.encode_chunk_rows(data, lens.long(), dense, 128)
    with pytest.raises(ValueError):
        kenc.encode_chunk_rows(data, lens, dense[:, :128], 128)
