"""The device-resident pipeline on the CPU: the table build's plain
version, the device tables, ``compress_blocks_device`` and
``decode_blocks_device`` against the JAX package and the host builders.

On the CPU every kernel wrapper takes its plain version; the CUDA
kernels themselves are held to these on the card
(``tests/test_torch_cuda.py``).  Mirrors ``tests/test_table_build.py``
and ``tests/test_device_api.py``.  Tolerance: exact — lengths, tables,
wire bytes and frames compared as integers and bytes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import data_compression_tpu as jx
from data_compression_tpu.huffman import batched as jhb
from data_compression_tpu.models.huffman import HuffmanCodec as JHuffmanCodec
from data_compression_tpu.ops import table_build as jtbd
import data_compression_tpu_torch as pt
from data_compression_tpu_torch import device_api, framing
from data_compression_tpu_torch.config import ARITY_MAX_LEN
from data_compression_tpu_torch.huffman import batched as hb
from data_compression_tpu_torch.ops import table_build as tbd
from data_compression_tpu_torch.ops.kernels import table_build as ktb
from data_compression_tpu_torch.utils.corpora import complete_lengths, deep_code_block, enwik_like
from tests.conftest import ascii_text
from tests.test_table_batch import _hist_suite

ARITIES = [2, 3, 16]
S = 128 * 128  # 128 chunks of 128 symbols, the JAX test's geometry


def _suite():
    return _hist_suite(np.random.default_rng(0))


@pytest.mark.parametrize("arity", ARITIES)
def test_plain_table_build_matches_jax_and_native(arity):
    hists = _suite()
    got = ktb.huffman_lengths(torch.from_numpy(hists), arity)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), hb.capped_lengths_batch(hists, arity))
    jax_lengths = jtbd.huffman_lengths_device(jnp.asarray(hists.astype(np.int32)), arity)
    assert np.array_equal(got.numpy(), np.asarray(jax_lengths))


@pytest.mark.parametrize("arity", [4, 10, 64])
def test_plain_table_build_at_other_arities_matches_native(arity):
    hists = _suite()
    got = ktb.huffman_lengths(torch.from_numpy(hists.astype(np.int32)), arity)
    assert np.array_equal(got.numpy(), hb.capped_lengths_batch(hists, arity))


def test_table_build_caps_and_edges():
    """Fibonacci counts (a 44-digit tree at n = 2, rebuilt until it fits),
    a flat histogram, one symbol, none, and counts past 2**31 in all."""
    fib = [1, 1]
    while len(fib) < 45:
        fib.append(fib[-1] + fib[-2])
    hists = np.zeros((5, 256), np.int64)
    hists[0, :45] = fib
    hists[1] = 1
    hists[2, 200] = 10**6
    hists[4] = np.arange(256, dtype=np.int64) * (1 << 26)
    for arity in ARITIES + [5]:
        got = ktb.huffman_lengths(torch.from_numpy(hists), arity).numpy()
        assert np.array_equal(got, hb.capped_lengths_batch(hists, arity))
        assert got[0].max() <= ARITY_MAX_LEN[arity] and got[2].sum() == 1 and not got[3].any()
    uncapped = ktb._build_once_ref(torch.from_numpy(hists), 2)
    assert int(uncapped[0].max()) == 44 > ARITY_MAX_LEN[2]
    with pytest.raises(KeyError):
        ktb.huffman_lengths(torch.from_numpy(hists), 65)
    with pytest.raises(ValueError):
        ktb.huffman_lengths(torch.zeros((2, 255), dtype=torch.int64), 2)
    assert ktb.huffman_lengths(torch.zeros((0, 256), dtype=torch.int64), 2).shape == (0, 256)


@pytest.mark.parametrize("rows", ["suite", "deep_code"])
@pytest.mark.parametrize("arity", ARITIES)
def test_build_tables_plain_matches_jax(arity, rows):
    """``build_tables`` on the CPU (its plain version) against the JAX
    ``huffman_lengths_device`` and its ``jnp`` encode tables, on the
    histogram suite and with the deep-code block's histogram in the last
    row (15-digit codes at n = 2).  Exact integers."""
    hists = _suite()
    if rows == "deep_code":
        deep = np.frombuffer(deep_code_block(65536, 3), np.uint8)
        hists[-1] = np.bincount(deep, minlength=256)
    before = ktb.build_tables.launches
    lengths, dense = ktb.build_tables(torch.from_numpy(hists), arity)
    assert ktb.build_tables.launches == before  # the plain version counts no launch
    jlengths = jtbd.huffman_lengths_device(jnp.asarray(hists.astype(np.int32)), arity)
    assert np.array_equal(lengths.numpy(), np.asarray(jlengths))
    jdense, _ = jtbd.encode_tables_device(jlengths, arity)
    assert np.array_equal(dense.numpy(), np.asarray(jdense).reshape(len(hists), -1))
    assert np.array_equal(lengths.numpy(), hb.capped_lengths_batch(hists, arity))
    if rows == "deep_code" and arity == 2:
        assert int(lengths[-1].max()) == ARITY_MAX_LEN[2]
    with pytest.raises(KeyError):
        ktb.build_tables(torch.from_numpy(hists), 10)


@pytest.mark.parametrize("arity", ARITIES)
def test_device_tables_match_host_and_jax(arity):
    """With a complete tree at the length cap in the last row."""
    hists = _suite()
    lengths = hb.capped_lengths_batch(hists, arity)
    if arity != 2:
        lengths[-1] = complete_lengths(arity, ARITY_MAX_LEN[arity], 256 if arity == 16 else 255)
    tb = hb.codes_batch(lengths, arity)
    dense, n_used = tbd.encode_tables_device(torch.from_numpy(lengths), arity)
    assert np.array_equal(dense.numpy(), hb.dense_rows(tb).reshape(len(lengths), -1))
    assert np.array_equal(n_used.numpy(), tb.n_used)
    jdense, _ = jtbd.encode_tables_device(jnp.asarray(lengths), arity)
    assert np.array_equal(dense.numpy(), np.asarray(jdense).reshape(len(lengths), -1))

    L = ARITY_MAX_LEN[arity]
    limit, bmf, symbols = tbd.decode_tables_device(torch.from_numpy(tb.table_bytes()), arity)
    dr = jhb.decode_rows(jhb.codes_batch(lengths, arity), L)
    assert np.array_equal(limit.numpy(), dr["limit_scaled"].astype(np.int32))
    assert np.array_equal(bmf.numpy(), dr["base_minus_first"].astype(np.int32))
    assert np.array_equal(symbols.numpy(), dr["symbols"])
    for got, want in zip((limit, bmf, symbols), hb.decode_tensors(tb, "cpu").values()):
        assert torch.equal(got, want)


def test_device_tables_reject_arities_without_kernels():
    lengths = torch.zeros((1, 256), dtype=torch.int32)
    for fn in (tbd.encode_tables_device, tbd.decode_tables_device):
        with pytest.raises(KeyError):
            fn(lengths, 4)


def _blocks(data, block_size=S):
    blocks, lens = framing.split_blocks(data, block_size)
    return blocks, lens


@pytest.mark.parametrize("arity", ARITIES)
def test_compress_blocks_device_wire_parity(arity):
    """The payload bytes and table rows of the JAX package's host
    encoder, as its own device-pipeline test checks them; and the frame
    of ``compress`` in both packages.  The CPU takes the per-stage path,
    never the card's native chain."""
    data = ascii_text(np.random.default_rng(arity), S + S // 2)
    blocks, lens = _blocks(data)
    cfg = pt.CodecConfig(arity=arity, block_size=S, chunk_syms=128)
    fn = device_api.compress_blocks_device
    chained, finished = fn.chained, fn.finish_launches
    dc = fn(torch.from_numpy(blocks), torch.from_numpy(lens), cfg, device="cpu")
    assert (fn.chained, fn.finish_launches) == (chained, finished)
    flat, nb, rows, raw_lens = dc.download()
    jcfg = jx.CodecConfig(arity=arity, block_size=S, chunk_syms=128, use_device=False)
    hists = np.stack([np.bincount(blocks[i, : lens[i]], minlength=256)
                      for i in range(len(lens))]).astype(np.int64)
    tb = jhb.codes_batch(jhb.capped_lengths_batch(hists, arity), arity)
    assert np.array_equal(rows, tb.table_bytes())
    chunks = JHuffmanCodec(jcfg)._encode_host(blocks, lens, tb)
    assert flat.tobytes() == b"".join(b"".join(c) for c in chunks)
    assert np.array_equal(raw_lens, lens) and nb.shape == (2, 128)
    frame = device_api.to_frame(dc, blocks, cfg)
    assert frame == pt.compress(data, cfg, device="cpu") == jx.compress(data, jcfg)


@pytest.mark.parametrize("arity", ARITIES)
def test_decode_blocks_device_round_trip(arity):
    """Every chunk of every block, empty ones too, decoded from the
    pipeline's own flat payload and table rows."""
    data = enwik_like(3 * S - 700, 5) + deep_code_block(S, 6)
    blocks, lens = _blocks(data)
    cfg = pt.CodecConfig(arity=arity, block_size=S, chunk_syms=128)
    dc = device_api.compress_blocks_device(torch.from_numpy(blocks), torch.from_numpy(lens),
                                           cfg, device="cpu")
    inputs = device_api.chunk_inputs(dc)
    assert inputs[1][-1] == dc.total
    out = device_api.decode_blocks_device(*inputs, dc.table_rows, arity, 128, device="cpu")
    out = out.view(len(lens), S).numpy()
    for i, n in enumerate(lens):
        assert np.array_equal(out[i, :n], blocks[i, :n])


def test_compress_blocks_device_overflow_and_capacity():
    """Random bytes outgrow their raw size: with the default capacity the
    flat buffer holds the first B * S payload bytes and ``download``
    compacts again; a capacity above the payload leaves zeros past it."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 2 * S, dtype=np.uint8).tobytes()
    blocks, lens = _blocks(data)
    cfg = pt.CodecConfig(block_size=S, chunk_syms=128)
    dc = device_api.compress_blocks_device(torch.from_numpy(blocks), lens, cfg, device="cpu")
    total = int(dc.total)
    assert total > 2 * S == dc.flat.numel()
    flat = dc.download()[0]
    assert flat.size == total and np.array_equal(flat[: 2 * S], dc.flat.numpy())
    assert device_api.to_frame(dc, blocks, cfg) == pt.compress(data, cfg, device="cpu")
    big = device_api.compress_blocks_device(torch.from_numpy(blocks), lens, cfg,
                                            out_cap=total + 100, device="cpu")
    assert np.array_equal(big.flat[:total].numpy(), flat) and not big.flat[total:].any()


def test_compress_blocks_device_rejects_what_it_does_not_run():
    blocks = torch.zeros((1, S), dtype=torch.uint8)
    lens = torch.tensor([S], dtype=torch.int32)
    for cfg, err in ((pt.CodecConfig(block_size=S, shared_table=True), ValueError),
                     (pt.CodecConfig(codec="nybble", block_size=S), ValueError),
                     (pt.CodecConfig(arity=4, block_size=S), KeyError),
                     (pt.CodecConfig(), ValueError)):  # block size differs from S
        with pytest.raises(err):
            device_api.compress_blocks_device(blocks, lens, cfg, device="cpu")
    with pytest.raises(ValueError):
        device_api.compress_blocks_device(blocks, lens[:0], pt.CodecConfig(block_size=S),
                                          device="cpu")
    with pytest.raises(ValueError):
        device_api.compress_blocks_device(blocks, lens, pt.CodecConfig(block_size=S),
                                          device="meta")
