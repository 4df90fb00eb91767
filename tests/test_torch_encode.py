"""Encode kernel module: the plain version ``encode_blocks_ref`` against
the TPU kernel ``_encode_pallas_compact`` (Pallas interpret mode on the
CPU) and the JAX package's per-chunk host encoder, with the same tables
carried across by ``TableBatch.from_arrays``.

Tolerance: exact — equal digit counts and equal valid payload bytes
(bytes past a block's payload are undefined in both and not compared).
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


def _port(data, raw_lens, tp, C):
    dense = phb.to_device(tp, "cpu")["dense"]
    rows, digits, bb = kenc.encode_blocks_ref(
        torch.from_numpy(data), torch.from_numpy(raw_lens.astype(np.int32)), dense, C
    )
    return rows.numpy(), digits.numpy(), bb.numpy()


def test_encode_ref_matches_pallas_compact_kernel():
    """C=128 (16 KiB blocks), B=2 with a short second block: the port's
    rows and per-chunk digits equal the TPU kernel's in interpret mode."""
    import jax.numpy as jnp

    from data_compression_tpu.ops.pallas.encode_kernel import LANES, _encode_pallas_compact

    C = 128
    S = C * LANES
    data = np.frombuffer(enwik_like(2 * S, 21), np.uint8).reshape(2, S).copy()
    raw_lens = np.array([S, S - 3 * C - 7], np.int64)
    data[1, raw_lens[1]:] = 0
    tj, tp = _tables(data, raw_lens)

    meta = np.stack([tj.n_used, raw_lens.astype(np.int32)], axis=1).astype(np.int32)
    syms_t = jnp.transpose(data.reshape(2, LANES, C), (0, 2, 1))
    words, nbd = _encode_pallas_compact(
        syms_t, jnp.asarray(jhb.dense_rows(tj)), jnp.asarray(meta), arity=2,
        chunk_syms=C, interpret=True,
    )
    j_digits = np.transpose(np.asarray(nbd), (0, 2, 1)).reshape(2, LANES)
    j_bytes = np.asarray(words).reshape(2, -1).view(np.uint8)

    rows, digits, bb = _port(data, raw_lens, tp, C)
    np.testing.assert_array_equal(digits, j_digits)
    np.testing.assert_array_equal(bb, ((j_digits + 7) // 8).sum(axis=1))
    assert rows.shape == (2, LANES * max_chunk_bytes(C, 2))
    for b in range(2):
        n = int(bb[b])
        assert rows[b, :n].tobytes() == j_bytes[b, :n].tobytes(), f"block {b}"
    assert (digits[1, -3:] == 0).all()  # chunks past the short block's end


@pytest.mark.parametrize("case", ["deep_code_512", "partial_chunk_512", "tiny_16"])
def test_encode_ref_matches_host_encoder(case):
    """Per-chunk payloads equal the JAX package's host encoder, including
    15-digit codes, a partial last chunk and a 16-symbol chunk."""
    if case == "deep_code_512":
        C, S = 512, 65536
        data = np.frombuffer(deep_code_block(S, 4), np.uint8).reshape(1, S).copy()
        raw_lens = np.array([S], np.int64)
    elif case == "partial_chunk_512":
        C, S = 512, 4096
        data = np.frombuffer(enwik_like(3 * S, 8), np.uint8).reshape(3, S).copy()
        raw_lens = np.array([S, 2 * 512 + 77, 1], np.int64)
    else:
        C, S = 16, 256
        data = np.frombuffer(enwik_like(2 * S, 9), np.uint8).reshape(2, S).copy()
        raw_lens = np.array([S, 40], np.int64)
    for b, n in enumerate(raw_lens):
        data[b, n:] = 0
    tj, tp = _tables(data, raw_lens)
    if case == "deep_code_512":
        assert int(tj.max_len[0]) == 15, "fixture lost its depth"
    rows, digits, bb = _port(data, raw_lens, tp, C)
    for b in range(len(raw_lens)):
        want = b""
        for c in range(S // C):
            cnt = max(0, min(C, int(raw_lens[b]) - c * C))
            chunk = encode_chunk_np(data[b, c * C : c * C + cnt], tj.table(b))
            assert (int(digits[b, c]) + 7) // 8 == len(chunk)
            want += chunk
        assert int(bb[b]) == len(want)
        assert rows[b, : len(want)].tobytes() == want, f"block {b}"


def test_encode_wrapper_cpu_dispatch_and_checks():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; malformed inputs raise ValueError."""
    data = torch.zeros((1, 256), dtype=torch.uint8)
    lens = torch.tensor([256], dtype=torch.int32)
    dense = torch.zeros((1, 256), dtype=torch.int32)
    dense[0, 0] = 1 << 15  # symbol 0: one digit, code 0
    before = kenc.encode_blocks.launches
    rows, digits, bb = kenc.encode_blocks(data, lens, dense, 128)
    assert kenc.encode_blocks.launches == before
    assert digits.tolist() == [[128, 128]] and bb.tolist() == [32]
    assert not rows[0, :32].any()
    with pytest.raises(ValueError):
        kenc.encode_blocks(data, lens, dense, 96)  # not a power of two
    with pytest.raises(ValueError):
        kenc.encode_blocks(data, lens.long(), dense, 128)
    with pytest.raises(ValueError):
        kenc.encode_blocks(data.int(), lens, dense, 128)
