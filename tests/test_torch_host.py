"""The port's host layer against the JAX package's originals.

The port carries jax-free copies of the host modules (config, framing,
huffman/*); each copy must agree exactly with its original on the same
inputs.  Tolerance: exact (integer arrays and bytes compared with ==).
"""

import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import data_compression_tpu.framing as jframing
import data_compression_tpu.huffman.batched as jhb
from data_compression_tpu.config import CodecConfig as JConfig
from data_compression_tpu.huffman.canonical import lengths_to_codes as j_lengths_to_codes
from data_compression_tpu.huffman.tree import huffman_lengths as j_huffman_lengths
from data_compression_tpu.ops.encode_fast import BITS_PER_DIGIT as J_BPD
from data_compression_tpu.ops.huffman_coding import max_chunk_bytes as j_max_chunk_bytes
from data_compression_tpu.ops.pallas.encode_kernel import PACKED_LEN_SHIFT as J_SHIFT

import data_compression_tpu_torch.framing as pframing
import data_compression_tpu_torch.huffman.batched as phb
from data_compression_tpu_torch import config as pconfig
from data_compression_tpu_torch.config import CodecConfig as PConfig
from data_compression_tpu_torch.huffman.canonical import lengths_to_codes as p_lengths_to_codes
from data_compression_tpu_torch.huffman.tree import huffman_lengths as p_huffman_lengths
from data_compression_tpu_torch.ops.histogram import block_histograms
from data_compression_tpu_torch.utils.corpora import deep_code_block, enwik_like

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hists(kind):
    rng = np.random.default_rng(11)
    if kind == "random":
        return rng.integers(0, 1000, size=(4, 256)).astype(np.int64) * (
            rng.random((4, 256)) < 0.6
        )
    if kind == "single":
        h = np.zeros((3, 256), np.int64)
        h[0, 65] = 1000
        h[1, 0] = 1
        h[2, 255] = 7
        return h
    if kind == "fib_deep":
        d = np.frombuffer(deep_code_block(65536, 2), np.uint8)
        return np.bincount(d, minlength=256)[None, :].astype(np.int64)
    if kind == "enwik":
        d = np.frombuffer(enwik_like(4 * 65536, 5), np.uint8).reshape(4, -1)
        return np.stack([np.bincount(r, minlength=256) for r in d]).astype(np.int64)
    if kind == "empty_row":
        h = np.zeros((2, 256), np.int64)
        h[1, 10:20] = 3
        return h
    raise ValueError(kind)


HIST_KINDS = ["random", "single", "fib_deep", "enwik", "empty_row"]


def test_import_hygiene():
    """A fresh import of the port (every module of it) leaves jax and the
    JAX package unimported.  A subprocess, because this test process has
    jax loaded by conftest."""
    code = (
        "import sys\n"
        "import data_compression_tpu_torch, data_compression_tpu_torch.cli\n"
        "import data_compression_tpu_torch.ops.kernels.encode\n"
        "import data_compression_tpu_torch.ops.kernels.compact\n"
        "import data_compression_tpu_torch.ops.kernels.decode\n"
        "import data_compression_tpu_torch.models.huffman\n"
        "import data_compression_tpu_torch.utils.corpora\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'data_compression_tpu' or m.startswith('data_compression_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


def test_constants_match():
    from data_compression_tpu import config as jconfig

    assert pconfig.ARITY_MAX_LEN == jconfig.ARITY_MAX_LEN
    assert pconfig.ARITY_DIGITS_PER_BYTE == jconfig.ARITY_DIGITS_PER_BYTE
    assert pconfig.CODEC_IDS == jconfig.CODEC_IDS
    assert pconfig.MAX_CODE_LEN == jconfig.MAX_CODE_LEN
    assert phb.BITS_PER_DIGIT == J_BPD
    assert phb.PACKED_LEN_SHIFT == J_SHIFT
    for C in (16, 128, 512, 4096):
        for n in (2, 3, 16):
            assert pconfig.max_chunk_bytes(C, n) == j_max_chunk_bytes(C, n)


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"codec": "bogus"},
        {"arity": 1},
        {"arity": 65},
        {"block_size": 0},
        {"block_size": 1000, "chunk_syms": 300},
        {"block_size": 768, "chunk_syms": 96},
        {"codec": "nybble", "block_size": 1000, "chunk_syms": 1000},
    ],
)
def test_codec_config_validation_matches(kwargs):
    """Same defaults, same accept/reject decisions as the original."""
    try:
        JConfig(**kwargs)
        j_ok = True
    except ValueError:
        j_ok = False
    try:
        p = PConfig(**kwargs)
        p_ok = True
    except ValueError:
        p_ok = False
    assert p_ok == j_ok
    if p_ok:
        j = JConfig(**kwargs)
        for f in ("codec", "arity", "block_size", "chunk_syms", "shared_table"):
            assert getattr(p, f) == getattr(j, f)
        assert p.codec_id == j.codec_id


@pytest.mark.parametrize("kind", HIST_KINDS)
def test_tree_and_canonical_match(kind):
    for f in _hists(kind):
        for n in (2, 3, 16):
            lj = j_huffman_lengths(f, n, max_len=64)
            lp = p_huffman_lengths(f, n, max_len=64)
            np.testing.assert_array_equal(lp, lj)
        cap = jhb.capped_lengths_batch(f[None, :], 2)[0]
        tj, tp = j_lengths_to_codes(cap, 2), p_lengths_to_codes(cap, 2)
        for field in ("lengths", "codes", "first_code", "count", "base_index",
                      "sorted_symbols"):
            np.testing.assert_array_equal(getattr(tp, field), getattr(tj, field))
        assert (tp.max_len, tp.min_len) == (tj.max_len, tj.min_len)
        assert tp.to_bytes() == tj.to_bytes()


@pytest.mark.parametrize("kind", HIST_KINDS)
def test_batched_tables_match(kind):
    """capped_lengths_batch (pure Python here, native C in the original),
    codes_batch, packed_rows, dense_rows and decode_rows agree."""
    h = _hists(kind)
    lj = jhb.capped_lengths_batch(h, 2)
    lp = phb.capped_lengths_batch(h, 2)
    np.testing.assert_array_equal(lp, lj)
    if kind == "fib_deep":
        assert lp.max() == 15, "fixture lost its depth"
    tj, tp = jhb.codes_batch(lj, 2), phb.codes_batch(lp, 2)
    for f in dataclasses.fields(tj):
        np.testing.assert_array_equal(getattr(tp, f.name), getattr(tj, f.name))
    for a, b in zip(phb.packed_rows(tp), jhb.packed_rows(tj)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(phb.dense_rows(tp), jhb.dense_rows(tj))
    dj, dp = jhb.decode_rows(tj, 15), phb.decode_rows(tp, 15)
    for k in dj:
        np.testing.assert_array_equal(dp[k], dj[k])
    np.testing.assert_array_equal(
        phb.tables_from_bytes(tp.table_bytes(), 2).codes,
        jhb.tables_from_bytes(tj.table_bytes(), 2).codes,
    )


def test_kraft_violation_raises_in_both():
    rows = np.zeros((1, 256), np.uint8)
    rows[0, :3] = 1  # three codes of one binary digit
    with pytest.raises(ValueError):
        jhb.tables_from_bytes(rows, 2)
    with pytest.raises(ValueError):
        phb.tables_from_bytes(rows, 2)


@pytest.mark.parametrize("kind", ["enwik", "fib_deep"])
def test_from_arrays_and_to_device(kind):
    """Tables carried across: the JAX package's TableBatch fields
    (dataclasses.asdict) give the same kernel-side tensors."""
    h = _hists(kind)
    tj = jhb.codes_batch(jhb.capped_lengths_batch(h, 2), 2)
    tp = phb.TableBatch.from_arrays(dataclasses.asdict(tj))
    B = h.shape[0]
    d = phb.to_device(tp, "cpu")
    assert {k: (v.dtype, tuple(v.shape)) for k, v in d.items()} == {
        "dense": (torch.int32, (B, 256)),
        "limit": (torch.int32, (B, 16)),
        "bmf": (torch.int32, (B, 16)),
        "symbols": (torch.int32, (B, 256)),
    }
    np.testing.assert_array_equal(d["dense"].numpy(), jhb.dense_rows(tj).reshape(B, 256))
    dj = jhb.decode_rows(tj, 15)
    np.testing.assert_array_equal(d["limit"].numpy(), dj["limit_scaled"])
    np.testing.assert_array_equal(d["bmf"].numpy(), dj["base_minus_first"])
    np.testing.assert_array_equal(d["symbols"].numpy(), dj["symbols"])
    with pytest.raises(ValueError):
        phb.TableBatch.from_arrays({"arity": 2})


@pytest.mark.parametrize("kind", ["enwik", "single", "empty_row"])
def test_block_histograms_match(kind):
    """The port's bincount histogram equals the JAX package's one-hot
    matmul (run on the CPU) and numpy, with padding dropped."""
    from data_compression_tpu.ops.histogram import block_histograms as j_hist

    rng = np.random.default_rng(3)
    B, S = 3, 4096
    if kind == "enwik":
        blocks = np.frombuffer(enwik_like(B * S, 9), np.uint8).reshape(B, S).copy()
    elif kind == "single":
        blocks = np.full((B, S), 200, np.uint8)
    else:
        blocks = rng.integers(0, 256, (B, S), dtype=np.uint8)
    lengths = np.array([S, 1234, 0], np.int64)
    got = block_histograms(torch.from_numpy(blocks), torch.from_numpy(lengths)).numpy()
    want = np.stack([np.bincount(blocks[i, : lengths[i]], minlength=256)
                     for i in range(B)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(j_hist(blocks, lengths)))


def _frame_args(shared):
    rng = np.random.default_rng(5)
    payloads = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in (0, 17, 300)]
    return dict(
        codec_id=4, arity=2, block_size=65536, total_len=123456,
        payloads=payloads, raw_lens=[0, 65536, 57920],
        crcs=[1, 0xFFFFFFFF, 12345], block_flags=[2, 1, 0],
        shared_table=bytes(range(256)) if shared else None, chunk_log2=9,
    )


@pytest.mark.parametrize("shared", [False, True])
def test_pack_unpack_frame_match(shared):
    args = _frame_args(shared)
    fj, fp = jframing.pack_frame(**args), pframing.pack_frame(**args)
    assert fp == fj
    uj, up = jframing.unpack_frame(fj), pframing.unpack_frame(fj)
    for f in ("codec_id", "arity", "block_size", "total_len", "flags",
              "shared_table", "payloads", "chunk_log2", "chunk_syms", "codec_name"):
        assert getattr(up, f) == getattr(uj, f)
    assert [dataclasses.astuple(e) for e in up.entries] == [
        dataclasses.astuple(e) for e in uj.entries]
    # streamed containers: read_frame splits a concatenation identically
    s = io.BytesIO(fj + fj)
    assert pframing.read_frame(s) == fj
    assert pframing.read_frame(s) == fj
    assert pframing.read_frame(s) is None
    for cut in (3, 20, len(fj) - 1):
        with pytest.raises(ValueError):
            pframing.unpack_frame(fj[:cut])
        with pytest.raises(ValueError):
            pframing.read_frame(io.BytesIO(fj[:cut]))


def test_split_blocks_match():
    for n in (0, 1, 4095, 4096, 4097, 10000):
        data = bytes(np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8))
        bj, lj = jframing.split_blocks(data, 4096)
        bp, lp = pframing.split_blocks(data, 4096)
        np.testing.assert_array_equal(bp, bj)
        np.testing.assert_array_equal(lp, lj)


def test_printable_container_not_ported():
    from data_compression_tpu import compress as jcompress

    blob = jcompress(b"hello world " * 50,
                     JConfig(block_size=4096, use_device=False), printable=True)
    with pytest.raises(NotImplementedError):
        pframing.unpack_frame(blob)
    with pytest.raises(NotImplementedError):
        pframing.read_frame(io.BytesIO(blob))
