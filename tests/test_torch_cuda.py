"""CUDA kernels on the card: each kernel against its plain version on
the same CUDA tensors, and the slice on ``cuda`` against the port's CPU
path.  Marked ``cuda``; every test skips where no CUDA device is
available (decided inside the fixture, never at import).  Run on a GPU
machine with ``python -m pytest tests/test_torch_cuda.py -m cuda``.

Tolerance: exact — valid output bytes must be equal.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import data_compression_tpu_torch as pt
from data_compression_tpu_torch import framing, native
from data_compression_tpu_torch.config import ARITY_MAX_LEN, max_chunk_bytes, wire_bytes
from data_compression_tpu_torch.huffman import batched as hb
from data_compression_tpu_torch.huffman.batched import to_device
from data_compression_tpu_torch.models.huffman import HuffmanCodec
from data_compression_tpu_torch.ops.kernels import compact as kcmp
from data_compression_tpu_torch.ops.kernels import copy as kcopy
from data_compression_tpu_torch.ops.kernels import decode as kdec
from data_compression_tpu_torch.ops.kernels import encode as kenc
from data_compression_tpu_torch.ops.kernels import microbench as kmb
from data_compression_tpu_torch.parallel import compress_sharded, decompress_sharded, make_mesh
from data_compression_tpu_torch.parallel import multihost
from data_compression_tpu_torch.tools import ablate, microbench, timing
from data_compression_tpu_torch.utils.corpora import (
    GENERATORS,
    complete_lengths,
    deep_code_block,
    enwik_like,
    printable_like,
)

pytestmark = pytest.mark.cuda
ARITIES = [2, 16, 3]
GOLDEN = Path(__file__).parent / "data" / "torch_golden.json"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _data():
    # 7 enwik-like blocks, one deep-code block, a partial last block
    return enwik_like(7 * 65536, 61) + deep_code_block(65536, 62) + enwik_like(3000, 63)


def _deep_tables(codec, dev_blocks, dev_lens, n):
    """The blocks' tables, with block 7's replaced at n = 3 and 16 by a
    complete tree that reaches the length cap (the deep-code block does
    so by itself only at n = 2)."""
    tb, _ = codec.tables(dev_blocks, dev_lens)
    if n != 2:
        lengths = tb.lengths.copy()
        lengths[7] = complete_lengths(n, ARITY_MAX_LEN[n], 256 if n == 16 else 255)
        tb = hb.codes_batch(lengths, n)
    return tb


@pytest.mark.parametrize("n", ARITIES)
@pytest.mark.parametrize("chunk_syms", [512, 128])
def test_kernels_match_plain_versions(cuda, chunk_syms, n):
    cfg = pt.CodecConfig(arity=n, chunk_syms=chunk_syms)
    codec = HuffmanCodec(cfg, cuda)
    blocks, lengths = framing.split_blocks(_data(), cfg.block_size)
    dev_blocks, dev_lens = codec.upload_blocks(blocks, lengths)
    tb = _deep_tables(codec, dev_blocks, dev_lens, n)
    dense = to_device(tb, cuda)["dense"]

    rows, digits, bb = kenc.encode_blocks(dev_blocks, dev_lens, dense, chunk_syms, n)
    rows_r, digits_r, bb_r = kenc.encode_blocks_ref(dev_blocks, dev_lens, dense, chunk_syms, n)
    assert torch.equal(digits, digits_r) and torch.equal(bb, bb_r)
    valid = torch.arange(rows.shape[1], device=cuda)[None, :] < bb[:, None].long()
    assert torch.equal(rows[valid], rows_r[valid])

    flat = kcmp.compact_blocks(rows, bb)
    assert torch.equal(flat, kcmp.compact_blocks_ref(rows, bb))

    frame = framing.unpack_frame(pt.compress(_data(), cfg, device=cuda))
    args, _ = codec.decode_inputs(
        frame.payloads, [e.raw_len for e in frame.entries], frame.shared_table
    )
    out = kdec.decode_chunks(**args)
    out_r = kdec.decode_chunks_ref(**args)
    valid = torch.arange(chunk_syms, device=cuda)[None, :] < args["chunk_cnt"][:, None]
    assert torch.equal(out[valid], out_r[valid])


@pytest.mark.parametrize("n", ARITIES)
@pytest.mark.parametrize("shared", [False, True])
def test_slice_on_cuda_matches_cpu(cuda, shared, n):
    x = _data()
    cfg = pt.CodecConfig(arity=n, shared_table=shared)
    counts = [f.launches for f in (kenc.encode_blocks, kcmp.compact_blocks, kdec.decode_chunks)]
    frame = pt.compress(x, cfg, device=cuda)
    assert frame == pt.compress(x, cfg, device="cpu")
    assert pt.decompress(frame, device=cuda) == x
    after = [f.launches for f in (kenc.encode_blocks, kcmp.compact_blocks, kdec.decode_chunks)]
    assert all(a > c for a, c in zip(after, counts))


@pytest.mark.parametrize("n", ARITIES)
@pytest.mark.parametrize("chunk_syms", [512, 1024, 16])
def test_rows_kernel_matches_plain_version(cuda, chunk_syms, n):
    """Per-chunk rows: equal digits and equal valid bytes, with chunk 0
    of block 7 made of L-digit symbols so its row is full."""
    cfg = pt.CodecConfig(arity=n, chunk_syms=chunk_syms)
    codec = HuffmanCodec(cfg, cuda)
    blocks, lengths = framing.split_blocks(_data(), cfg.block_size)
    dev_blocks, dev_lens = codec.upload_blocks(blocks, lengths)
    tb = _deep_tables(codec, dev_blocks, dev_lens, n)
    dense = to_device(tb, cuda)["dense"]
    L = ARITY_MAX_LEN[n]
    deep = torch.from_numpy(np.flatnonzero(tb.lengths[7] == L).astype(np.uint8)).to(cuda)
    dev_blocks[7, :chunk_syms] = deep[torch.arange(chunk_syms, device=cuda) % deep.numel()]
    before = kenc.encode_chunk_rows.launches
    rows, digits = kenc.encode_chunk_rows(dev_blocks, dev_lens, dense, chunk_syms, n)
    assert kenc.encode_chunk_rows.launches == before + 1
    rows_r, digits_r = kenc.encode_chunk_rows_ref(dev_blocks, dev_lens, dense, chunk_syms, n)
    assert torch.equal(digits, digits_r)
    assert int(digits.max()) == L * chunk_syms
    valid = torch.arange(rows.shape[1], device=cuda)[None, :] < wire_bytes(digits[:, None].long(), n)
    assert torch.equal(rows[valid], rows_r[valid])


def _emitter_edge_inputs(n, C, S, B, seed, dev):
    """B blocks of S symbols drawn from skewed random distributions (some
    symbols take 1-digit codes), each coded by the canonical table of its
    own histogram; the last block by a complete tree at the length cap,
    with chunk 0 all L-digit symbols (its wire bytes fill
    max_chunk_bytes).  Raw lengths end most blocks 0-39 symbols into a
    chunk, so the last chunks carry from 0 to a few tens of wire bytes;
    one block is empty and one full."""
    rng = np.random.default_rng(seed)
    L = ARITY_MAX_LEN[n]
    blocks = np.empty((B, S), np.uint8)
    for b in range(B):
        p = rng.dirichlet(np.full(256, 0.05))
        blocks[b] = rng.choice(256, S, p=p)
    hists = np.stack([np.bincount(r, minlength=256) for r in blocks])
    lengths = hb.capped_lengths_batch(hists, n)
    lengths[-1] = complete_lengths(n, L, 255 if n == 3 else 256)
    deep = np.flatnonzero(lengths[-1] == L)
    blocks[-1, :C] = deep[np.arange(C) % deep.size]
    raw = C * rng.integers(0, S // C, B) + rng.integers(0, min(C, 40), B)
    raw[0], raw[-2], raw[-1] = 0, S, S
    tb = hb.codes_batch(lengths, n)
    return (torch.from_numpy(blocks).to(dev), torch.from_numpy(raw.astype(np.int32)).to(dev),
            to_device(tb, dev)["dense"])


@pytest.mark.parametrize("n", ARITIES)
@pytest.mark.parametrize("chunk_syms,S,B", [(16, 4096, 24), (128, 4096, 24), (512, 4096, 24),
                                            (1024, 8192, 24), (16, 65536, 3)])
def test_encode_kernels_emitter_edges(cuda, chunk_syms, S, B, n):
    """Both encode kernels at the edges of their shared-memory images and
    16-byte stores: compact chunk offsets at every alignment 0-15, chunks
    of 0 to a few tens of wire bytes, rows strides that are no multiple
    of 16 (C = 16), a full max_chunk_bytes chunk in both layouts, chunks
    that span two warp passes (C = 1024), and (S = 65536 at C = 16) rows
    of 4096 chunks, 32 to a warp pass.  Valid bytes, digit counts, block
    bytes and the rows kernel's stage-2 byte sums equal the plain
    versions."""
    C, L = chunk_syms, ARITY_MAX_LEN[n]
    blocks, raw, dense = _emitter_edge_inputs(n, C, S, B, 90 + n + C + S, cuda)

    rows, digits, bb = kenc.encode_blocks(blocks, raw, dense, C, n)
    rows_r, digits_r, bb_r = kenc.encode_blocks_ref(blocks, raw, dense, C, n)
    assert torch.equal(digits, digits_r) and torch.equal(bb, bb_r)
    assert int(digits.max()) == L * C
    valid = torch.arange(rows.shape[1], device=cuda)[None, :] < bb[:, None].long()
    assert torch.equal(rows[valid], rows_r[valid])
    nb = wire_bytes(digits.long(), n)
    off = (torch.cumsum(nb, 1) - nb)[nb > 0]
    assert set((off % 16).tolist()) == set(range(16))
    assert int(nb[nb > 0].min()) < 16 and int(nb.max()) == max_chunk_bytes(C, n)

    rows, digits = kenc.encode_chunk_rows(blocks, raw, dense, C, n)
    rows_r, digits_r = kenc.encode_chunk_rows_ref(blocks, raw, dense, C, n)
    assert torch.equal(digits, digits_r) and int(digits.max()) == L * C
    valid = torch.arange(rows.shape[1], device=cuda)[None, :] < wire_bytes(digits[:, None].long(), n)
    assert torch.equal(rows[valid], rows_r[valid])
    _, sums = kenc.encode_chunk_rows(blocks, raw, dense, C, n, stages=2)
    assert torch.equal(sums, kenc.encode_chunk_rows_ref(blocks, raw, dense, C, n, stages=2)[1])


@pytest.mark.parametrize("n", ARITIES)
@pytest.mark.parametrize("chunk_syms,S", [(512, 131072), (1024, 262144)])
def test_encode_kernels_long_blocks(cuda, chunk_syms, S, n):
    """Blocks of 256 warp passes: the compact kernel places them in two
    rounds of its CTA scan (at C = 1024 each chunk spans two passes)."""
    C = chunk_syms
    blocks, raw, dense = _emitter_edge_inputs(n, C, S, 3, 95 + n + C, cuda)
    rows, digits, bb = kenc.encode_blocks(blocks, raw, dense, C, n)
    rows_r, digits_r, bb_r = kenc.encode_blocks_ref(blocks, raw, dense, C, n)
    assert torch.equal(digits, digits_r) and torch.equal(bb, bb_r)
    valid = torch.arange(rows.shape[1], device=cuda)[None, :] < bb[:, None].long()
    assert torch.equal(rows[valid], rows_r[valid])
    rows, digits = kenc.encode_chunk_rows(blocks, raw, dense, C, n)
    rows_r, digits_r = kenc.encode_chunk_rows_ref(blocks, raw, dense, C, n)
    assert torch.equal(digits, digits_r)
    valid = torch.arange(rows.shape[1], device=cuda)[None, :] < wire_bytes(digits[:, None].long(), n)
    assert torch.equal(rows[valid], rows_r[valid])


@pytest.mark.parametrize("n", [16, 3])
def test_decode_kernel_complete_tree_and_random_bytes(cuda, n):
    """The decode kernel reads the encode kernel's payloads, with block 7
    coded by a complete tree at the length cap (n = 3: last limit exactly
    3^15, kept in value space) and its chunk 0 all L-digit codes; on
    random payload bytes (n = 3: bytes 243..255 too) it stays in bounds
    and agrees with its plain version."""
    cfg = pt.CodecConfig(arity=n)
    C = cfg.chunk_syms
    codec = HuffmanCodec(cfg, cuda)
    blocks, lengths = framing.split_blocks(_data(), cfg.block_size)
    dev_blocks, dev_lens = codec.upload_blocks(blocks, lengths)
    tb = _deep_tables(codec, dev_blocks, dev_lens, n)
    deep = torch.from_numpy(np.flatnonzero(tb.lengths[7] == ARITY_MAX_LEN[n]).astype(np.uint8))
    dev_blocks[7, :C] = deep.to(cuda)[torch.arange(C, device=cuda) % deep.numel()]
    dense = to_device(tb, cuda)["dense"]
    rows, digits, bb = kenc.encode_blocks(dev_blocks, dev_lens, dense, C, n)
    flat = kcmp.compact_blocks(rows, bb).cpu().numpy()
    nb = wire_bytes(digits.cpu().numpy().astype(np.int64), n)
    payloads = codec._assemble_payloads(flat, nb, lengths, tb.table_bytes())
    args, _ = codec.decode_inputs(payloads, lengths, None)
    assert int(args["limit"][7, -1]) == n ** ARITY_MAX_LEN[n]
    out = kdec.decode_chunks(**args)
    valid = torch.arange(C, device=cuda)[None, :] < args["chunk_cnt"][:, None]
    inside = torch.arange(dev_blocks.shape[1], device=cuda)[None, :] < dev_lens[:, None]
    assert torch.equal(out[valid], dev_blocks[inside])
    assert torch.equal(out[valid], kdec.decode_chunks_ref(**args)[valid])

    gen = torch.Generator(device=cuda).manual_seed(5)
    args["flat"] = torch.randint(0, 256, args["flat"].shape, dtype=torch.uint8,
                                 device=cuda, generator=gen)
    assert torch.equal(kdec.decode_chunks(**args)[valid], kdec.decode_chunks_ref(**args)[valid])


@pytest.mark.parametrize("n", ARITIES)
def test_decode_kernel_random_tables_and_bytes(cuda, n):
    """Seeded random tables (limits in [0, n**L], in no order; bmf and
    symbols arbitrary) on random bytes, in blocks of 1, 130 and 77 chunks
    with counts 0, 1, 3, 5, 17, 33 and C: every stage equals the plain
    version.  Each chunk holds at least cnt * L digits, so every symbol
    the plain version decodes comes from the chunk's own bytes."""
    rng = np.random.default_rng(70 + n)
    L, D, C = ARITY_MAX_LEN[n], {2: 8, 16: 2, 3: 5}[n], 512
    per_block = [1, 130, 77]
    B = len(per_block)
    limit = rng.integers(0, n**L + 1, (B, L + 1))
    limit[0] = np.sort(limit[0])
    tables = [torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (
        limit, rng.integers(-(1 << 20), 1 << 20, (B, L + 1)), rng.integers(0, 256, (B, 256)))]
    K = sum(per_block)
    cnt = np.array([0, 1, 3, 5, 17, 33, C])[np.arange(K) % 7]
    sizes = -(-cnt * L // D) + rng.integers(0, 9, K)
    off = np.concatenate([[0], np.cumsum(sizes)])
    args = dict(
        flat=torch.from_numpy(rng.integers(0, 256, int(off[-1]), dtype=np.uint8)).to(cuda),
        chunk_off=torch.from_numpy(off.astype(np.int64)).to(cuda),
        chunk_cnt=torch.from_numpy(cnt.astype(np.int32)).to(cuda),
        chunk_blk=torch.from_numpy(np.repeat(np.arange(B), per_block).astype(np.int32)).to(cuda),
        limit=tables[0], bmf=tables[1], symbols=tables[2], chunk_syms=C, arity=n)
    valid = torch.arange(C, device=cuda)[None, :] < args["chunk_cnt"][:, None]
    out = kdec.decode_chunks(**args)
    assert torch.equal(out[valid], kdec.decode_chunks_ref(**args)[valid])
    for k in (1, 2, 3):
        got = kdec.stage_sums(kdec.decode_chunks(**args, stages=k))
        assert torch.equal(got, kdec.stage_sums(kdec.decode_chunks_ref(**args, stages=k)))


@pytest.mark.parametrize("n", ARITIES)
@pytest.mark.parametrize("chunk_syms", [16, 128, 512, 1024])
def test_decode_kernel_chunk_geometry(cuda, chunk_syms, n):
    """Frames of 64 KiB blocks at every chunk size (4096 down to 64
    chunks per block; a partial last block) decode on the card as the
    plain version decodes them, and give back the input."""
    cfg = pt.CodecConfig(arity=n, chunk_syms=chunk_syms)
    assert cfg.block_size == 65536
    codec = HuffmanCodec(cfg, cuda)
    x = _data()
    frame = framing.unpack_frame(pt.compress(x, cfg, device=cuda))
    args, _ = codec.decode_inputs(frame.payloads, [e.raw_len for e in frame.entries],
                                  frame.shared_table)
    out = kdec.decode_chunks(**args)
    valid = torch.arange(chunk_syms, device=cuda)[None, :] < args["chunk_cnt"][:, None]
    assert torch.equal(out[valid], kdec.decode_chunks_ref(**args)[valid])
    assert out[valid].cpu().numpy().tobytes() == x


def test_sharded_one_rank_nccl_matches_compress(cuda, tmp_path):
    x = _data()
    multihost.initialize("nccl", f"file://{tmp_path}/store", 1, 0, device=cuda)
    try:
        mesh = make_mesh(cuda)
        for shared in (False, True):
            cfg = pt.CodecConfig(shared_table=shared)
            frame = compress_sharded(x, cfg, mesh)
            assert frame == pt.compress(x, cfg, device=cuda)
            assert decompress_sharded(frame, None, mesh) == x
    finally:
        torch.distributed.destroy_process_group()


def _outcome(stream, device):
    try:
        return pt.decompress(stream, device=device)
    except ValueError:
        return ValueError


@pytest.mark.parametrize("n", ARITIES)
def test_corrupt_frame_raises_on_cuda(cuda, n):
    """Byte flips raise ValueError on cuda exactly where they do on the
    CPU (at n = 3 a flip of padding trits alone decodes correctly)."""
    x = enwik_like(3 * 4096, 64)
    cfg = pt.CodecConfig(arity=n, block_size=4096, chunk_syms=512)
    stream = bytearray(pt.compress(x, cfg, device=cuda))
    rng = np.random.default_rng(9)
    body = len(stream) - sum(e.comp_len for e in framing.unpack_frame(bytes(stream)).entries)
    for pos in rng.integers(body, len(stream), 8):
        corrupt = bytearray(stream)
        corrupt[int(pos)] ^= 0xFF
        got = _outcome(bytes(corrupt), cuda)
        assert got == _outcome(bytes(corrupt), "cpu")
        if n != 3:
            assert got is ValueError


def test_wrappers_reject_bad_cuda_inputs(cuda):
    blocks = torch.zeros((2, 1024), dtype=torch.uint8, device=cuda)
    lens = torch.full((2,), 1024, dtype=torch.int32, device=cuda)
    dense = torch.zeros((2, 256), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kenc.encode_blocks(blocks[:, ::2], lens, dense, 256)  # not contiguous
    with pytest.raises(ValueError):
        kenc.encode_blocks(blocks, lens.cpu(), dense, 512)  # mixed devices
    with pytest.raises(ValueError):
        kenc.encode_chunk_rows(blocks[:, ::2], lens, dense, 256)  # not contiguous
    with pytest.raises(ValueError):
        kenc.encode_chunk_rows(blocks, lens, dense.cpu(), 256)  # mixed devices
    rows = torch.zeros((2, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        kcmp.compact_blocks(rows, torch.tensor([65, 0], dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        kcmp.compact_blocks(rows, torch.tensor([-1, 3], dtype=torch.int32, device=cuda))
    bb = torch.tensor([5, 0], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kcmp.compact_launcher(rows, bb)(torch.empty(6, dtype=torch.uint8, device=cuda))
    with pytest.raises(ValueError):
        kcmp.compact_launcher(rows, bb)(torch.empty(5, dtype=torch.uint8))  # on the CPU
    with pytest.raises(ValueError):
        kcmp.compact_blocks(rows, bb, total=-5)
    with pytest.raises(ValueError):
        kcmp.compact_blocks(rows[:0], bb[:0], total=5)
    z = torch.zeros((1, 16), dtype=torch.int32, device=cuda)
    args = dict(flat=torch.zeros(4, dtype=torch.uint8, device=cuda),
                chunk_off=torch.tensor([0, 8], dtype=torch.int64, device=cuda),  # past flat
                chunk_cnt=torch.tensor([16], dtype=torch.int32, device=cuda),
                chunk_blk=torch.zeros(1, dtype=torch.int32, device=cuda),
                limit=z, bmf=z, symbols=torch.zeros((1, 256), dtype=torch.int32, device=cuda),
                chunk_syms=16)
    with pytest.raises(ValueError):
        kdec.decode_chunks(**args)


def _compact_rows(B, N, src_off, block_bytes, seed, dev):
    """[B, N] random rows taken from a view ``src_off`` bytes into its
    storage, and their block byte counts as an int32 tensor."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    store = torch.randint(0, 256, (B * N + 16,), dtype=torch.uint8, device=dev, generator=gen)
    rows = store[src_off : src_off + B * N].view(B, N)
    assert rows.data_ptr() % 16 == src_off % 16 and rows.is_contiguous()
    return rows, torch.tensor(block_bytes, dtype=torch.int32, device=dev)


def _guarded_launch(rows, bb, dst_off):
    """The kernel alone (``compact_launcher``) into a canvas larger than
    its output, ``dst_off`` bytes off 16-byte alignment; asserts the
    output equals the plain version and no byte outside it changed."""
    want = kcmp.compact_blocks_ref(rows, bb)
    total = want.numel()
    canvas = torch.full((total + 64,), 0xA5, dtype=torch.uint8, device=rows.device)
    start = 16 + dst_off
    assert (canvas.data_ptr() + start) % 16 == dst_off
    before = kcmp.compact_blocks.launches
    kcmp.compact_launcher(rows, bb)(canvas[start : start + total])
    assert kcmp.compact_blocks.launches == before + (total > 0)
    assert torch.equal(canvas[start : start + total], want)
    assert bool((canvas[:start] == 0xA5).all()) and bool((canvas[start + total:] == 0xA5).all())


@pytest.mark.parametrize("N", [8, 30, 64, 1000, 122880])
def test_compact_kernel_every_alignment(cuda, N):
    """Destination alignments 0-15 crossed with source alignments: rows
    of width N from views 0-15 bytes into their storage; blocks of 0
    bytes, of 1-15, random, and one that fills its row."""
    rng = np.random.default_rng(N)
    B = 24 if N == 122880 else 64
    for src_off in range(16):
        bb = rng.integers(0, N + 1, B)
        bb[rng.integers(0, B, B // 4)] = rng.integers(0, min(N, 15) + 1, B // 4)
        bb[0], bb[B // 2], bb[-1] = 0, N, rng.integers(1, min(N, 15) + 1)
        rows, bbt = _compact_rows(B, N, src_off, bb.tolist(), N + src_off, cuda)
        assert torch.equal(kcmp.compact_blocks(rows, bbt), kcmp.compact_blocks_ref(rows, bbt))
        for dst_off in range(16):
            _guarded_launch(rows, bbt, dst_off)


@pytest.mark.parametrize("B", [1, 1024, 4096])
def test_compact_kernel_tiny_and_empty_blocks(cuda, B):
    """Blocks of 0-15 bytes, several to one 16-byte word, at every
    destination alignment; a total of 0; B = 1, 1024 and 4096."""
    rng = np.random.default_rng(B)
    for N, src_off in ((16, 0), (30, 5), (64, 11)):
        bb = rng.integers(0, 16, B)
        bb[rng.random(B) < 0.3] = 0
        rows, bbt = _compact_rows(B, N, src_off, bb.tolist(), B + N, cuda)
        for dst_off in range(16):
            _guarded_launch(rows, bbt, dst_off)
        zero = torch.zeros_like(bbt)
        before = kcmp.compact_blocks.launches
        assert kcmp.compact_blocks(rows, zero).numel() == 0
        assert kcmp.compact_blocks(rows, zero, total=0).numel() == 0
        assert kcmp.compact_blocks.launches == before
        _guarded_launch(rows, zero, 3)


@pytest.mark.parametrize("n", ARITIES)
def test_compact_on_the_compress_path_makes_no_host_read(cuda, n, monkeypatch):
    """The compress path's call of the compaction (the total given) runs
    under ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    synchronising call; the same call without the total raises there."""
    x = _data()
    cfg = pt.CodecConfig(arity=n)
    wrapper = kcmp.compact_blocks
    calls = []

    def no_sync(rows, block_bytes, total=None):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            flat = wrapper(rows, block_bytes, total=total)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls.append((total, rows, block_bytes, flat))
        return flat

    monkeypatch.setattr(kcmp, "compact_blocks", no_sync)
    frame = pt.compress(x, cfg, device=cuda)
    monkeypatch.undo()
    assert len(calls) == 1 and calls[0][0] == calls[0][3].numel() > 0
    assert frame == pt.compress(x, cfg, device="cpu")
    _, rows, bb, flat = calls[0]
    assert torch.equal(flat, kcmp.compact_blocks_ref(rows, bb))
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            kcmp.compact_blocks(rows, bb)  # the checked call reads back once
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_copy_kernel_matches_clone(cuda):
    """The main path's [128, 512, 128] blocks, and a flat size with a
    tail of 9 bytes."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    for shape in ((128, 512, 128), (1_000_009,)):
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=cuda, generator=gen)
        before = kcopy.copy_blocks.launches
        y = kcopy.copy_blocks(x)
        assert kcopy.copy_blocks.launches == before + 1
        assert torch.equal(y, kcopy.copy_blocks_ref(x)) and y.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("size", [0, 1, 15, 16, 17, (1 << 20) + 3, (64 << 20) + 5])
def test_copy_kernel_any_length(cuda, size):
    """Empty, shorter than one 16-byte word, one word, a word and a tail,
    and sizes that are no multiple of the kernel's tile."""
    gen = torch.Generator(device=cuda).manual_seed(size)
    x = torch.randint(0, 256, (size,), dtype=torch.uint8, device=cuda, generator=gen)
    before = kcopy.copy_blocks.launches
    y = kcopy.copy_blocks(x)
    assert kcopy.copy_blocks.launches == before + (size > 0)
    assert torch.equal(y, x.clone())


@pytest.mark.parametrize("name", kmb.VARIANTS)
def test_lookup_kernels_match_plain_versions(cuda, name):
    """The microbenchmark's B = 128 inputs, and at C = 576 random tables
    with negative entries (stage1_like's lane mask cuts in there)."""
    s, tables = microbench.make_inputs(microbench.B, cuda)
    before = kmb.WRAPPERS[name].launches
    got = kmb.lookup_variant(name, s, tables[name])
    assert kmb.WRAPPERS[name].launches == before + 1
    assert torch.equal(got, kmb.lookup_variant_ref(name, s, tables[name]))
    gen = torch.Generator(device=cuda).manual_seed(12)
    s = torch.randint(0, 256, (3, 576, 128), dtype=torch.uint8, device=cuda, generator=gen)
    t = tables[name]
    if t is not None:
        t = torch.randint(-2**31, 2**31, (3, *t.shape[1:]), dtype=torch.int64, device=cuda,
                          generator=gen).to(t.dtype)
    assert torch.equal(kmb.lookup_variant(name, s, t), kmb.lookup_variant_ref(name, s, t))


@pytest.mark.parametrize("n", ARITIES)
def test_stage_observables_match_plain_full_versions(cuda, n):
    """Rows-encode stages 1-2 and decode stages 1-3 against their
    definitions from the plain full versions, stage 3 rows and stage 4
    symbols against the plain versions, with block 7 coded by a table
    at the length cap and its chunk 0 all L-digit codes."""
    cfg = pt.CodecConfig(arity=n)
    C = cfg.chunk_syms
    codec = HuffmanCodec(cfg, cuda)
    data = _data()
    blocks, lengths = framing.split_blocks(data, cfg.block_size)
    dev_blocks, dev_lens = codec.upload_blocks(blocks, lengths)
    tb = _deep_tables(codec, dev_blocks, dev_lens, n)
    deep = torch.from_numpy(np.flatnonzero(tb.lengths[7] == ARITY_MAX_LEN[n]).astype(np.uint8))
    dev_blocks[7, :C] = deep.to(cuda)[torch.arange(C, device=cuda) % deep.numel()]
    dense = to_device(tb, cuda)["dense"]
    rows, digits = kenc.encode_chunk_rows(dev_blocks, dev_lens, dense, C, n)
    nb = wire_bytes(digits.long(), n)
    flat = rows[torch.arange(rows.shape[1], device=cuda)[None, :] < nb[:, None]]
    payloads = codec._assemble_payloads(flat.cpu().numpy(), nb.view(len(lengths), -1).cpu().numpy(),
                                        lengths, tb.table_bytes())
    args, _ = codec.decode_inputs(payloads, lengths, None)
    inp = ablate.Inputs(data, n, C, dev_blocks, dev_lens, dense, tb, args)
    errs = ablate.check_stages(inp)
    assert len(errs) == 7 and not any(errs.values())
    assert int(digits.max()) == ARITY_MAX_LEN[n] * C


def test_tools_run_on_the_card(cuda):
    report = ablate.run(2, 8, cuda, min_trial_s=0.01)
    keys = {"passthrough_ms", "passthrough_gbps", "passthrough_library_ms", "encode_stage1_ms",
            "encode_stage2_ms", "encode_stage3_ms", "encode_compact_ms", "encode_lookup_ms",
            "encode_merge_ms", "encode_wire_ms", "encode_gbps", "compact_ms", "compact_gbps",
            "compact_wrapper_ms", "decode_window_walk_ms", "decode_rank_ms",
            "decode_ranksym_ms", "decode_store_ms", "decode_gbps", "copy_envelope_gbps"}
    assert keys <= set(report) and report["arity"] == 2 and report["mb"] == 8
    assert all(np.isfinite(report[k]) for k in keys)
    assert all(report[k] > 0 for k in keys if not k.endswith(("merge_ms", "wire_ms", "rank_ms",
                                                                "ranksym_ms", "store_ms")))
    assert set(report["device_ms"]) == {
        "passthrough", "passthrough_library", *(f"encode_stage{k}" for k in (1, 2, 3)),
        "encode_compact", "compact", "compact_wrapper", *(f"decode_stage{k}" for k in (1, 2, 3, 4))}
    assert report["compact_bytes"] > 0
    assert all(0 < v < 1e3 for v in report["device_ms"].values())
    results = microbench.run(cuda, reps=3)
    assert [r["variant"] for r in results] == list(kmb.VARIANTS)
    assert all(r["ms"] > 0 and r["gbps"] > 0 for r in results)
    assert {r["variant"] for r in results if "library_ms" in r} == set(microbench.LIBRARY_VARIANTS)


@pytest.mark.parametrize("n", ARITIES)
def test_main_path_tables_come_from_the_native_builder(cuda, n, monkeypatch):
    """A 64 MiB compress on cuda (chip_smoke.py's input) builds its 1024
    blocks' code lengths in one native call, never in the plain builder,
    and its frame is the plain builder's; the golden Huffman cases of
    this arity hash as recorded."""
    data = enwik_like((64 << 20) - 65536, 7) + deep_code_block(65536, 7)
    cfg = pt.CodecConfig(arity=n)
    calls = []
    real = native.huffman_capped_lengths_batch
    monkeypatch.setattr(native, "huffman_capped_lengths_batch",
                        lambda h, *a: calls.append(h.shape) or real(h, *a))

    def plain(*a):
        raise AssertionError("the plain builder ran on the main path")

    monkeypatch.setattr(hb, "capped_lengths_batch_ref", plain)
    frame = pt.compress(data, cfg, device=cuda)
    assert calls == [(1024, 256)]
    monkeypatch.undo()
    monkeypatch.setattr(hb, "capped_lengths_batch", hb.capped_lengths_batch_ref)
    assert pt.compress(data, cfg, device=cuda) == frame
    monkeypatch.undo()
    assert pt.decompress(frame, device=cuda) == data
    for case in json.loads(GOLDEN.read_text())["cases"]:
        if case["codec"] == "huffman" and case["arity"] == n:
            f = pt.compress(GENERATORS[case["gen"]](case["size"], case["seed"]),
                            pt.CodecConfig(arity=n, shared_table=case["shared_table"]),
                            device=cuda)
            assert (len(f), hashlib.sha256(f).hexdigest()) == (case["length"], case["sha256"])


SERIAL = [("literal", {}), ("nybble", {}), ("small_byte", {}),
          ("small_byte", {"isprint_literal": True}), ("small_nybble", {})]


@pytest.mark.parametrize("codec,kw", SERIAL, ids=["literal", "nybble", "small_byte",
                                                  "small_byte_isprint", "small_nybble"])
def test_serial_codecs_round_trip_on_cuda(cuda, codec, kw):
    """Made for cuda, the serial codecs run on the host: the frame is the
    CPU's and round-trips."""
    x = enwik_like(300_000, 64) + printable_like(65536, 65) + bytes(range(256)) * 40
    cfg = pt.CodecConfig(codec=codec, **kw)
    frame = pt.compress(x, cfg, device=cuda)
    assert frame == pt.compress(x, cfg, device="cpu")
    assert pt.decompress(frame, device=cuda) == x


def test_serial_codec_for_cuda_with_cuda_hidden_raises(cuda, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for codec, kw in SERIAL:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.compress(b"abc", pt.CodecConfig(codec=codec, **kw), device=cuda)


def test_device_ms_of_the_copy_is_at_or_above_its_hbm_bound(cuda):
    """No whole profiler session can read the copy of 64 MiB faster than
    device memory moves its 128 MiB."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randint(0, 256, (64 << 20,), dtype=torch.uint8, device=cuda, generator=gen)
    bound_ms = 2 * x.numel() / HBM_BYTES_PER_S * 1e3
    assert timing.device_ms(lambda: kcopy.copy_blocks(x)) >= bound_ms
    dst = torch.empty_like(x)
    assert timing.device_ms(lambda: dst.copy_(x)) >= bound_ms

