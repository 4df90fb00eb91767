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
from data_compression_tpu_torch import device_api, framing, native
from data_compression_tpu_torch.config import ARITY_MAX_LEN, max_chunk_bytes, wire_bytes
from data_compression_tpu_torch.huffman import batched as hb
from data_compression_tpu_torch.huffman.batched import to_device
from data_compression_tpu_torch.models.huffman import HuffmanCodec
from data_compression_tpu_torch.ops.kernels import compact as kcmp
from data_compression_tpu_torch.ops.kernels import copy as kcopy
from data_compression_tpu_torch.ops.kernels import decode as kdec
from data_compression_tpu_torch.ops.kernels import encode as kenc
from data_compression_tpu_torch.ops.kernels import _build
from data_compression_tpu_torch.ops.kernels import histogram as khist
from data_compression_tpu_torch.ops.kernels.histogram import block_histograms
from data_compression_tpu_torch.ops.kernels import microbench as kmb
from data_compression_tpu_torch.ops.kernels import table_build as ktb
from data_compression_tpu_torch.parallel import compress_sharded, decompress_sharded, make_mesh
from data_compression_tpu_torch.parallel import multihost
from data_compression_tpu_torch.tools import ablate, microbench, timing
from data_compression_tpu_torch.utils.corpora import (
    GENERATORS,
    complete_lengths,
    long_small_blocks,
    deep_code_block,
    enwik_like,
    printable_like,
    payload_mix,
    tight_span_payload,
)
from data_compression_tpu_torch.ops import scan_codecs as psc
from data_compression_tpu_torch.ops.kernels import serial_lanes as lanes
from torch_cases import (
    HIST_ROW_KINDS,
    LANE_KINDS,
    decode_table_rows,
    decoded_as_native,
    hist_blocks,
    lane_blocks,
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


def test_measure_encode_throughput_one_rank_nccl(cuda, tmp_path):
    """The scaling harness's step on the card: JAX's keys, and the
    gathered counts equal the plain rows encode's wire bytes."""
    cfg = pt.CodecConfig()
    nbytes = 8 * 65536 + 1000
    multihost.initialize("nccl", f"file://{tmp_path}/store", 1, 0, device=cuda)
    try:
        mesh = make_mesh(cuda)
        kenc.encode_chunk_rows.launches = 0
        r = multihost.measure_encode_throughput(cfg, nbytes, iters=2, device=cuda)
        assert kenc.encode_chunk_rows.launches == 6  # two warm-ups, two steps a trial
        assert (r["bytes"], r["processes"], r["devices"]) == (nbytes, 1, 1)
        assert r["bytes_per_s"] > 0 and r["collective_s"] >= 0
        blocks, lens, dense = multihost.encode_share(cfg, nbytes, mesh)
        counts = multihost.encode_counts(blocks, lens, dense, cfg, mesh)
        _, digits = kenc.encode_chunk_rows_ref(blocks, lens, dense, cfg.chunk_syms, cfg.arity)
        assert torch.equal(counts, wire_bytes(digits, cfg.arity))
    finally:
        torch.distributed.destroy_process_group()


def test_dryrun_multichip_one_nccl_rank(cuda):
    from data_compression_tpu_torch.parallel import dryrun

    report = dryrun.dryrun_multichip(1, "cuda", timeout=300)
    assert report["mesh"] == {"data": 1, "chunk": 1} and report["jax_modules"] == []
    assert set(report["frames"]) == set(dryrun.ROUND_TRIPS)


def test_scaling_bench_more_ranks_than_cards_raises(cuda):
    from data_compression_tpu_torch.tools import scaling_bench

    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"{n} NCCL ranks need {n} CUDA devices"):
        scaling_bench.run(n, 1, "cuda")


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


@pytest.mark.parametrize("tail", [0, 1, 15, 16, 17, 2 * 16384 + 5])
def test_compact_kernel_zeros_past_the_payload(cuda, tail):
    """An output ``tail`` bytes longer than the payload (the device
    pipeline hands the kernel its whole capacity), at every destination
    alignment: the payload as the exact-total compaction writes it, every
    byte past it 0, nothing outside the output touched."""
    rng = np.random.default_rng(tail)
    B, N = 64, 1000
    bb = rng.integers(0, N + 1, B)
    bb[::7] = rng.integers(0, 16, len(bb[::7]))
    rows, bbt = _compact_rows(B, N, 5, bb.tolist(), tail, cuda)
    want = kcmp.compact_blocks(rows, bbt)
    payload = want.numel()
    total = payload + tail
    for dst_off in range(16):
        canvas = torch.full((total + 64,), 0xA5, dtype=torch.uint8, device=cuda)
        start = 16 + dst_off
        out = canvas[start : start + total]
        kcmp.compact_launcher(rows, bbt, total=total)(out)
        assert torch.equal(out[:payload], want), dst_off
        assert not bool(out[payload:].any()), dst_off
        assert bool((canvas[:start] == 0xA5).all()) and bool((canvas[start + total:] == 0xA5).all())


def _chain_inputs(B, S, n, seed, dev):
    """[B, S] blocks on ``dev``: windows of one text, all zeros, one
    16-byte record repeated and random bytes in turn, at n = 2 a block
    whose code reaches the 15-digit cap; lengths S, 0, 1, S - 1 and
    random in turn."""
    rng = np.random.default_rng(seed)
    text = np.frombuffer(enwik_like(S * 8, seed), np.uint8)
    kinds = [lambda i: text[(i * 997) % (7 * S):][:S], lambda i: np.zeros(S, np.uint8),
             lambda i: np.tile(rng.integers(0, 256, 16, dtype=np.uint8), S // 16),
             lambda i: rng.integers(0, 256, S, dtype=np.uint8)]
    blocks = np.zeros((B, S), np.uint8)
    for i in range(B):
        blocks[i] = kinds[i % 4](i)
    if n == 2 and B > 5:
        blocks[5] = np.frombuffer(deep_code_block(S, seed), np.uint8)
    picks = [S, 0, 1, S - 1]
    lens = np.array([picks[i % 5] if i % 5 < 4 else int(rng.integers(0, S + 1))
                     for i in range(B)], np.int32)
    return torch.from_numpy(blocks).to(dev), torch.from_numpy(lens).to(dev)


@pytest.mark.parametrize("out_cap", [None, 0, 1000, "payload"])
@pytest.mark.parametrize("B", [0, 1, 7, 1023, 1024])
@pytest.mark.parametrize("n", ARITIES)
def test_compress_chain_matches_the_kernel_wrappers(cuda, n, B, out_cap):
    """The native chain of ``compress_blocks_device`` against the four
    kernel wrappers and the torch ops they were joined by, bit for bit:
    ``flat`` (the first ``out_cap`` payload bytes, zeros past the payload),
    ``nb``, ``total``, ``table_rows``, ``raw_lens``, ``block_bytes`` and
    each row's valid bytes."""
    S, C = 4096, 128
    cfg = pt.CodecConfig(arity=n, block_size=S, chunk_syms=C)
    blocks, lens = _chain_inputs(B, S, n, 10 * B + n, cuda)
    hist = block_histograms(blocks, lens)
    lengths, dense = ktb.build_tables(hist, n)
    rows, digits, bb = kenc.encode_blocks(blocks, lens, dense, C, n)
    payload = kcmp.compact_blocks(rows, bb)
    cap = {None: B * S, "payload": payload.numel()}.get(out_cap, out_cap)
    flat = torch.zeros(cap, dtype=torch.uint8, device=cuda)
    flat[: min(cap, payload.numel())] = payload[:cap]
    counters = (block_histograms, ktb.build_tables, kenc.encode_blocks, kcmp.compact_blocks)
    before = [w.launches for w in counters]
    fn = device_api.compress_blocks_device
    chained, finished = fn.chained, fn.finish_launches
    dc = fn(blocks, lens, cfg, out_cap=None if out_cap is None else cap)
    assert fn.chained == chained + 1 and fn.finish_launches == finished + 1
    # a kernel with no work is not launched: the first three with no blocks,
    # the compaction with no capacity
    assert [w.launches - b for w, b in zip(counters, before)] == [int(B > 0)] * 3 + [int(cap > 0)]
    assert torch.equal(dc.flat, flat)
    assert torch.equal(dc.nb, wire_bytes(digits, n))
    assert dc.total.dtype == torch.int64 and dc.total.shape == ()
    assert int(dc.total) == payload.numel() == int(bb.sum())
    assert torch.equal(dc.table_rows, lengths.to(torch.uint8))
    assert torch.equal(dc.raw_lens, lens) and torch.equal(dc.block_bytes, bb)
    assert dc.rows.shape == rows.shape
    valid = torch.arange(rows.shape[1], device=cuda)[None, :] < bb[:, None]
    assert torch.equal(dc.rows[valid], rows[valid])
    assert np.array_equal(dc.download()[0], payload.cpu().numpy())


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


@pytest.mark.parametrize("name", kmb.VARIANTS)
def test_lookup_kernels_at_both_block_widths(cuda, name):
    """B = 1 and 128, C = 64 and 512 against the plain version byte for
    byte: at C = 512 each variant runs at its own words a thread, at
    C = 64 a 4-word variant at 2 (its 16 KiB slice does not divide the
    8 KiB block)."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    for B in (1, 128):
        s_full, tables = microbench.make_inputs(B, cuda)
        for C in (64, 512):
            s = torch.randint(0, 256, (B, C, 128), dtype=torch.uint8, device=cuda, generator=gen)
            before = kmb.WRAPPERS[name].launches
            got = kmb.lookup_variant(name, s, tables[name])
            assert kmb.WRAPPERS[name].launches == before + 1
            assert torch.equal(got, kmb.lookup_variant_ref(name, s, tables[name])), (B, C)
        assert torch.equal(kmb.lookup_variant(name, s_full, tables[name]),
                           kmb.lookup_variant_ref(name, s_full, tables[name]))


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
    # compact_wrapper reads back, so its reading is the profiler's: None where no session was whole
    assert all(0 < v < 1e3 for k, v in report["device_ms"].items()
               if not (k == "compact_wrapper" and v is None))
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
    """Made for cuda, nybble, small_byte (its type-8 blocks) and
    small_nybble encode and decode in the lanes, the compaction packing
    the encode rows; literal and the ISPRINT mode's 0x1f blocks run on
    the host.  The frame is the CPU's and round-trips."""
    x = enwik_like(300_000, 64) + printable_like(65536, 65) + bytes(range(256)) * 40
    cfg = pt.CodecConfig(codec=codec, **kw)
    wrappers = ([lanes.ENCODERS[codec], lanes.DECODERS[codec], kcmp.compact_blocks]
                if codec != "literal" else [])
    before = [w.launches for w in wrappers]
    frame = pt.compress(x, cfg, device=cuda)
    assert pt.decompress(frame, device=cuda) == x
    assert all(w.launches > b for w, b in zip(wrappers, before))
    assert frame == pt.compress(x, cfg, device="cpu")


@pytest.mark.parametrize("codec,kw", SERIAL[1:], ids=["nybble", "small_byte",
                                                      "small_byte_isprint", "small_nybble"])
def test_serial_corrupt_frames_raise_on_cuda(cuda, codec, kw):
    """``tests/test_torch_serial.py``'s bit-flip and truncation fuzz on
    cuda: 1.5 blocks of text; one to three flipped bits in the payloads,
    the type, first and last payload byte flipped, and the frame cut at
    25-99%, each raises ValueError through the lanes."""
    cfg = pt.CodecConfig(codec=codec, block_size=8192, **kw)
    rng = np.random.default_rng(len(codec) + len(kw))
    make = printable_like if kw else enwik_like
    stream = pt.compress(make(12288, int(rng.integers(1 << 30))), cfg, device=cuda)
    frame = framing.unpack_frame(stream)
    lo, hi = len(stream) - sum(e.comp_len for e in frame.entries), len(stream)
    corrupt = []
    for _ in range(40):
        c = bytearray(stream)
        for _ in range(int(rng.integers(1, 4))):
            c[int(rng.integers(lo, hi))] ^= 1 << int(rng.integers(0, 8))
        corrupt.append(bytes(c))
    for pos in (lo, lo + 1, hi - 1):
        c = bytearray(stream)
        c[pos] ^= 0xFF
        corrupt.append(bytes(c))
    corrupt += [stream[: int(len(stream) * f)] for f in (0.25, 0.5, 0.9, 0.99)]
    for c in corrupt:
        with pytest.raises(ValueError):
            pt.decompress(c, device=cuda)


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



# ---- the device-resident pipeline and its table-build kernel ------------

def _table_hists():
    """Random, zipf, sparse, one-symbol, empty, flat and huge-count
    histograms, Fibonacci counts (a 44-digit tree at n = 2) and geometric
    counts whose capped tree reaches the length cap at n = 2, 3 and 16,
    then the block histograms of the 8-block input."""
    rng = np.random.default_rng(21)
    rows = [rng.integers(0, 1000, 256),
            np.bincount(rng.zipf(1.3, 65536).clip(1, 256) - 1, minlength=256),
            np.zeros(256, np.int64), np.ones(256, np.int64),
            np.arange(256, dtype=np.int64) * (1 << 26)]
    rows[2][[3, 77, 200]] = [5, 9, 1]
    single = np.zeros(256, np.int64)
    single[42] = 7
    fib = np.zeros(256, np.int64)
    fib[:45] = [1, 1] + [0] * 43
    for i in range(2, 45):
        fib[i] = fib[i - 1] + fib[i - 2]
    geometric = np.minimum(1.3 ** np.arange(256), 2.0**40).astype(np.int64) + 1
    blocks, lengths = framing.split_blocks(_data(), 65536)
    data = [np.bincount(blocks[i, :lengths[i]], minlength=256) for i in range(len(lengths))]
    return np.stack(rows + [single, np.zeros(256, np.int64), fib, geometric] + data).astype(np.int64)


@pytest.mark.parametrize("n", ARITIES + [10, 64])
def test_table_build_kernel_matches_plain_and_native(cuda, n):
    hists = _table_hists()
    before = ktb.huffman_lengths.launches
    got = ktb.huffman_lengths(torch.from_numpy(hists).to(cuda), n)
    assert ktb.huffman_lengths.launches == before + 1 and got.dtype == torch.int32
    assert np.array_equal(got.cpu().numpy(), hb.capped_lengths_batch(hists, n))
    assert torch.equal(got.cpu(), ktb.huffman_lengths_ref(torch.from_numpy(hists), n))
    if n in ARITIES:
        assert int(got[8].max()) == ARITY_MAX_LEN[n]  # the geometric row, at the cap
    # int32 counts, as the JAX function takes them, give the same lengths
    small = (hists < 2**31).all(1)
    got32 = ktb.huffman_lengths(torch.from_numpy(hists[small].astype(np.int32)).to(cuda), n)
    assert torch.equal(got32, got[torch.from_numpy(small).to(cuda)])


@pytest.mark.parametrize("n", ARITIES)
def test_build_tables_kernel_matches_plain_and_native(cuda, n):
    """Lengths and the encode table in one launch, on rows built in 32 and
    in 64 bits (the huge-count, Fibonacci and geometric rows)."""
    hists = _table_hists()
    assert (hists.sum(1) >= 1 << 22).sum() >= 2
    before = ktb.build_tables.launches
    lengths, dense = ktb.build_tables(torch.from_numpy(hists).to(cuda), n)
    assert ktb.build_tables.launches == before + 1
    want_lengths, want_dense = ktb.build_tables_ref(torch.from_numpy(hists), n)
    assert np.array_equal(lengths.cpu().numpy(), hb.capped_lengths_batch(hists, n))
    assert torch.equal(lengths.cpu(), want_lengths)
    assert dense.dtype == torch.int32 and torch.equal(dense.cpu(), want_dense)
    tb = hb.codes_batch(want_lengths.numpy(), n)
    assert np.array_equal(dense.cpu().numpy(), hb.dense_rows(tb).reshape(len(hists), -1))
    with pytest.raises(KeyError):
        ktb.build_tables(torch.from_numpy(hists).to(cuda), 10)


@pytest.mark.parametrize("source", ["histogram.cu", "table_build.cu", "decode_tables.cu",
                                    "microbench.cu", "nybble_lanes.cu", "small_lanes.cu",
                                    "compress_chain.cu"])
def test_kernels_use_no_stack_and_no_spill(cuda, source):
    usage = _build.ptxas_usage(source)
    assert usage
    for fn, u in usage.items():
        assert (u["stack"], u["spill_stores"], u["spill_loads"]) == (0, 0, 0), (fn, u)


def _hist_views(blocks, dev):
    """The blocks on ``dev`` as given, as a row view at an odd offset of
    a flat buffer, and as rows of a wider tensor (row stride S + 5)."""
    B, S = blocks.shape
    flat = torch.zeros(B * S + 1, dtype=torch.uint8, device=dev)
    flat[1:] = torch.from_numpy(blocks.reshape(-1)).to(dev)
    wide = torch.zeros((B, S + 5), dtype=torch.uint8, device=dev)
    wide[:, 3:3 + S] = torch.from_numpy(blocks).to(dev)
    return {"contiguous": torch.from_numpy(blocks).to(dev), "odd offset": flat[1:].view(B, S),
            "row stride": wide[:, 3:3 + S]}


@pytest.mark.parametrize("B", [1, 7, 256, 1024])
@pytest.mark.parametrize("S,kind", [(65536, "edges"), (4104, "edges"), (65536, "full"),
                                    (65536, "period16"), (4104, "period16"),
                                    (65536, "one_value")])
def test_histogram_kernel_matches_plain_version(cuda, B, S, kind):
    blocks, lengths = hist_blocks(kind, B, S, B + S)
    want = np.stack([np.bincount(blocks[i, :lengths[i]], minlength=256) for i in range(B)])
    lens = torch.from_numpy(lengths).to(cuda)
    for name, view in _hist_views(blocks, cuda).items():
        before = block_histograms.launches
        got = block_histograms(view, lens)
        assert block_histograms.launches == before + 1
        assert got.dtype == torch.int64 and got.shape == (B, 256)
        assert torch.equal(got, khist.block_histograms_ref(view, lens)), name
        assert np.array_equal(got.cpu().numpy(), want), name
    if B == 1 and S >= 2 * khist.MIN_SLICE:  # a row cut into slices, added up atomically
        assert khist.slices_for(B, S, torch.cuda.get_device_properties(cuda).multi_processor_count) > 1


@pytest.mark.parametrize("kind", HIST_ROW_KINDS)
def test_histogram_kernel_past_the_flush_limit(cuda, kind):
    """One row of 1 MiB (8 slices of 8 rounds: one value takes every
    counter of a thread to its flush limit), in each view."""
    S = 1 << 20
    blocks, lengths = hist_blocks(kind, 1, S, 11)
    assert khist.slices_for(1, S, torch.cuda.get_device_properties(cuda).multi_processor_count) == 8
    want = np.bincount(blocks[0], minlength=256)[None]
    lens = torch.from_numpy(lengths).to(cuda)
    for name, view in _hist_views(blocks, cuda).items():
        got = block_histograms(view, lens)
        assert torch.equal(got, khist.block_histograms_ref(view, lens)), name
        assert np.array_equal(got.cpu().numpy(), want), name


def test_histograms_make_no_host_read(cuda):
    blocks, lengths = framing.split_blocks(_data(), 65536)
    dev_blocks = torch.from_numpy(blocks).to(cuda)
    dev_lens = torch.from_numpy(lengths.astype(np.int32)).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hists = block_histograms(dev_blocks, dev_lens)
        sliced = block_histograms(dev_blocks[:2], dev_lens[:2])  # several CTAs per row
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = np.stack([np.bincount(blocks[i, :lengths[i]], minlength=256)
                     for i in range(len(lengths))])
    assert np.array_equal(hists.cpu().numpy(), want)
    assert np.array_equal(sliced.cpu().numpy(), want[:2])


@pytest.mark.parametrize("n", ARITIES)
def test_device_pipeline_makes_no_host_read(cuda, n):
    """``compress_blocks_device`` under ``set_sync_debug_mode("error")``;
    its frame is ``compress``'s and ``decode_blocks_device`` gives the
    input back; each of its five kernels launched once, by one native
    call (``chained``)."""
    data = _data()
    cfg = pt.CodecConfig(arity=n)
    blocks, lengths = framing.split_blocks(data, cfg.block_size)
    dev_blocks = torch.from_numpy(blocks).to(cuda)
    dev_lens = torch.from_numpy(lengths.astype(np.int32)).to(cuda)
    wrappers = (block_histograms, ktb.build_tables, kenc.encode_blocks, kcmp.compact_blocks)
    before = [w.launches for w in wrappers]
    chained = device_api.compress_blocks_device.chained
    finished = device_api.compress_blocks_device.finish_launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dc = device_api.compress_blocks_device(dev_blocks, dev_lens, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 1, 1, 1]
    assert device_api.compress_blocks_device.chained == chained + 1
    assert device_api.compress_blocks_device.finish_launches == finished + 1
    assert device_api.to_frame(dc, dev_blocks, cfg) == pt.compress(data, cfg, device=cuda)
    out = device_api.decode_blocks_device(*device_api.chunk_inputs(dc), dc.table_rows, n,
                                          cfg.chunk_syms)
    out = out.view(dev_blocks.shape)
    valid = torch.arange(cfg.block_size, device=cuda)[None, :] < dev_lens[:, None]
    assert torch.equal(out[valid], dev_blocks[valid])


def test_device_pipeline_overflow_compacts_again_on_download(cuda):
    """A capacity below the payload: ``flat`` holds its first bytes and
    ``download`` compacts again; random bytes at the default capacity
    B * S give ``compress``'s frame either way."""
    rng = np.random.default_rng(5)
    cfg = pt.CodecConfig()
    for data, out_cap in ((_data(), 1000), (rng.integers(0, 256, 3 * 65536, dtype=np.uint8).tobytes(),
                                           None)):
        blocks, lengths = framing.split_blocks(data, cfg.block_size)
        dev_blocks = torch.from_numpy(blocks).to(cuda)
        dc = device_api.compress_blocks_device(dev_blocks, torch.from_numpy(lengths), cfg,
                                               out_cap=out_cap)
        total = int(dc.total)
        flat = dc.download()[0]
        assert flat.size == total
        cap = dc.flat.numel()
        n = min(cap, total)
        assert np.array_equal(flat[:n], dc.flat[:n].cpu().numpy())
        assert device_api.to_frame(dc, blocks, cfg) == pt.compress(data, cfg, device="cpu")
        if out_cap is not None:
            assert total > cap == out_cap


@pytest.mark.parametrize("n", ARITIES)
@pytest.mark.parametrize("B", [0, 1, 7, 9, 1023, 1024])
def test_decode_tables_kernel_matches_plain_version(cuda, B, n):
    """Real rows, a complete tree at the cap, empty and one-symbol rows,
    random lengths 0..L and rows the encoder never writes, in turn:
    limit, bmf and symbols equal the plain version's bit for bit."""
    rows = torch.from_numpy(decode_table_rows("mixed", n, B, B + n))
    before = ktb.decode_tables.launches
    got = ktb.decode_tables(rows.to(cuda), n)
    assert ktb.decode_tables.launches == before + (B > 0)
    want = ktb.decode_tables(rows, n)  # the plain version, on the CPU
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n", ARITIES)
def test_decode_tables_outputs_do_not_overlap(cuda, n):
    """The wrapper's one allocation gives three contiguous int32 tensors
    of the plain version's shapes over disjoint bytes; the empty kernel
    on the same grid launches."""
    B, L = 9, ARITY_MAX_LEN[n]
    rows = torch.from_numpy(decode_table_rows("mixed", n, B, n)).to(cuda)
    outs = ktb.decode_tables(rows, n)
    assert [tuple(t.shape) for t in outs] == [(B, L + 1), (B, L + 1), (B, 256)]
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * 4) for t in outs)
    assert all(t.is_contiguous() and t.dtype == torch.int32 for t in outs)
    assert all(end <= start for (_, end), (start, _) in zip(spans, spans[1:]))
    ktb.decode_tables_floor(rows)
    torch.cuda.synchronize()


def _as_read(flat, off, C, n):
    """Each chunk's bytes as the decode kernel reads them, [s, e) with s =
    off[k] and e = off[k+1] clamped into flat and e >= s, then zeros
    (the kernel reads digits past a chunk's end as 0), cut or padded to
    max_chunk_bytes (C symbols read no further), laid back to back:
    -> (flat, chunk_off) for the plain version."""
    N, o, M = flat.numel(), off.cpu(), max_chunk_bytes(C, n)
    s = o[:-1].clamp(0, N)
    e = torch.minimum(torch.maximum(o[1:].clamp(0, N), s), s + M)
    host = flat.cpu()
    rows = torch.zeros((s.numel(), M), dtype=torch.uint8)
    for k, (a, b) in enumerate(zip(s.tolist(), e.tolist())):
        rows[k, :b - a] = host[a:b]
    return rows.view(-1), torch.arange(s.numel() + 1, dtype=torch.int64) * M


def _device_decode_case(n, dev):
    """(flat, chunk_off, chunk_cnt, chunk_blk, table_rows) of the 8-block
    input compressed on the card."""
    cfg = pt.CodecConfig(arity=n)
    blocks, lengths = framing.split_blocks(_data(), cfg.block_size)
    dc = device_api.compress_blocks_device(torch.from_numpy(blocks).to(dev),
                                           torch.from_numpy(lengths.astype(np.int32)).to(dev), cfg)
    return (*device_api.chunk_inputs(dc), dc.table_rows), blocks, lengths


@pytest.mark.parametrize("n", ARITIES)
def test_device_decompress_makes_no_host_read(cuda, n):
    """``decode_blocks_device`` under ``set_sync_debug_mode("error")``:
    two launches (decode tables, decode), the input back."""
    (flat, off, cnt, blk, rows), blocks, lengths = _device_decode_case(n, cuda)
    before = (ktb.decode_tables.launches, kdec.decode_chunks.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = device_api.decode_blocks_device(flat, off, cnt, blk, rows, n, 512)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (ktb.decode_tables.launches, kdec.decode_chunks.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    out = out.view(blocks.shape).cpu().numpy()
    for i, m in enumerate(lengths):
        assert np.array_equal(out[i, :m], blocks[i, :m])


@pytest.mark.parametrize("n", ARITIES)
def test_device_decode_reads_nothing_outside_flat(cuda, n):
    """Offsets past flat, before it and out of order, and table rows out
    of range and out of order.  flat lies between guard bytes in two
    canvases whose guards differ; if the kernel read a guard byte, the
    two outputs would differ.  Offsets past any allocation must not fault.
    The output equals the plain version's on each chunk's bytes clamped
    into flat (``_as_read``).  (compute-sanitizer does not run on the
    card's machine, so this stands in for it.)"""
    (flat, off, cnt, blk, rows), _, _ = _device_decode_case(n, cuda)
    N, K = flat.numel(), cnt.numel()
    guard = 4096
    canvases = []
    for fill in (0x00, 0xFF):
        canvas = torch.full((N + 2 * guard,), fill, dtype=torch.uint8, device=cuda)
        canvas[guard:guard + N] = flat
        canvases.append(canvas[guard:guard + N])
    rng = np.random.default_rng(n)
    far = 1 << 40
    cases = {
        "past the end": off + (N - int(off[-1]) // 2),
        "before the start": off - N // 2,
        "far past": torch.where(torch.arange(K + 1, device=cuda) > K // 2, off + far, off),
        "far before": off - far,
        "shuffled": off[torch.from_numpy(rng.permutation(K + 1)).to(cuda)],
    }
    limit, bmf, symbols = ktb.decode_tables(rows, n)
    for name, bad in cases.items():
        outs = [device_api.decode_blocks_device(f, bad, cnt, blk, rows, n, 512) for f in canvases]
        torch.cuda.synchronize()
        valid = torch.arange(512, device=cuda)[None, :] < cnt[:, None]
        assert torch.equal(outs[0][valid], outs[1][valid]), name
        want = kdec.decode_chunks_ref(*_as_read(flat, bad, 512, n), cnt.cpu(), blk.cpu(),
                                      limit.cpu(), bmf.cpu(), symbols.cpu(), 512, n)
        assert torch.equal(outs[0].cpu()[valid.cpu()], want[valid.cpu()]), name
        with pytest.raises(ValueError):
            kdec.decode_chunks(flat, bad, cnt, blk, limit, bmf, symbols, 512, n)
    # rows out of range or order: a CTA decodes the chunks its row's
    # search gives it (clamped into [0, K]); the others are not written
    B = rows.shape[0]
    for name, bad_blk in {"rows past B": blk + B, "rows below 0": blk - B - 1,
                          "rows shuffled": blk[torch.from_numpy(rng.permutation(K)).to(cuda)]}.items():
        outs = [device_api.decode_blocks_device(f, off, cnt, bad_blk, rows, n, 512)
                for f in canvases]
        torch.cuda.synchronize()
        start = torch.searchsorted(bad_blk, torch.arange(B + 1, dtype=torch.int32, device=cuda))
        start = start.clamp(0, K).cpu().tolist()
        written = torch.zeros(K, dtype=torch.bool, device=cuda)
        for b in range(B):
            written[start[b]:max(start[b], start[b + 1])] = True
        mask = valid & written[:, None]
        assert torch.equal(outs[0][mask], outs[1][mask]), name


# ---- the serial codecs' lanes ----------------------------------------------

SEVEN_BIT = {"nybble": True, "small_byte": True, "small_nybble": False}
GUARD = 4096


def _lane_flat(payloads, dev):
    plens = np.array([len(p) for p in payloads], np.int64)
    offsets = np.concatenate([[0], np.cumsum(plens)[:-1]]).astype(np.int64)
    flat = np.frombuffer(b"".join(payloads), np.uint8).copy()
    return (torch.from_numpy(flat).to(dev), torch.from_numpy(offsets).to(dev),
            torch.from_numpy(plens.astype(np.int32)).to(dev))


def _native_payloads(kind, blocks, lengths):
    """(rows the scheme takes, their raw bytes, their native payloads)."""
    keep = [i for i, (b, n) in enumerate(zip(blocks, lengths))
            if not (SEVEN_BIT[kind] and n and b[:n].max() >= 0x80)]
    raws = [blocks[i, : lengths[i]].tobytes() for i in keep]
    return keep, raws, [getattr(native, f"{kind}_encode")(r) for r in raws]


def _lanes_against_plain(kind, blocks, lengths, dev):
    """Encode and decode lanes on the card against their plain versions
    on the CPU, on the same inputs; the decode on the encoder's payloads."""
    B, S = blocks.shape
    enc, dec = lanes.ENCODERS[kind], lanes.DECODERS[kind]
    bt, lt = torch.from_numpy(blocks), torch.from_numpy(lengths)
    before = (enc.launches, dec.launches)
    rows, totals, status = enc(bt.to(dev), lt.to(dev))
    want_rows, want_totals, want_status = enc(bt, lt)
    assert torch.equal(status.cpu(), want_status) and torch.equal(totals.cpu(), want_totals)
    for i in range(B):
        n = int(want_totals[i])
        assert torch.equal(rows[i, :n].cpu(), want_rows[i, :n]), i
    ok = [i for i in range(B) if int(want_status[i]) == lanes.OK]
    payloads = [want_rows[i, : int(want_totals[i])].numpy().tobytes() for i in ok]
    raw = torch.from_numpy(lengths[ok].astype(np.int32))
    flat, offs, plens = _lane_flat(payloads, "cpu")
    out, st = dec(flat.to(dev), offs.to(dev), plens.to(dev), raw.to(dev), S)
    want_out, want_st = dec(flat, offs, plens, raw, S)
    assert st.cpu().tolist() == want_st.tolist() == [lanes.OK] * len(ok)
    for k, i in enumerate(ok):
        n = int(lengths[i])
        assert out[k, :n].cpu().numpy().tobytes() == want_out[k, :n].numpy().tobytes() \
            == blocks[i, :n].tobytes(), i
    assert (enc.launches, dec.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("kind", LANE_KINDS)
@pytest.mark.parametrize("B,S", [(1, 1), (7, 4096), (130, 6144), (10, 65536)])
def test_lane_kernels_match_plain_versions(cuda, kind, B, S):
    """Rows of every kind of ``lane_blocks`` (ragged, empty, slot wrap,
    the banned first word, one byte value, bytes >= 0x80), up to the
    codecs' default 64 KiB blocks (the plain step loops take 1-3 minutes
    on the CPU there)."""
    blocks, lengths = lane_blocks(kind, S, B + S, B=B)
    _lanes_against_plain(kind, blocks, lengths, cuda)


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_lane_kernels_match_plain_versions_on_one_byte_value(cuda, kind):
    """64 KiB of one byte value: the deepest words, up to the match caps
    (255 bytes, 511 nybbles)."""
    blocks = np.full((1, 65536), ord("a"), np.uint8)
    _lanes_against_plain(kind, blocks, np.array([65536]), cuda)


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_lane_kernels_at_64k_match_the_native_runtime(cuda, kind):
    blocks, lengths = lane_blocks(kind, 65536, 91)
    keep, raws, payloads = _native_payloads(kind, blocks, lengths)
    got = psc.encode_payloads(kind, blocks, lengths, cuda)
    assert [got[i] for i in keep] == payloads
    assert psc.decode_payloads(kind, payloads, [len(r) for r in raws], cuda) == raws


# Block sizes on both sides of the reach of a 16-bit generation counter
# per slot (one write a word, 127 / 128 slots a context): the longest
# block in which no slot can be written 65,536 times, and a longer one in
# which the one-context block writes every slot of its context more than
# 65,535 times.  The encoders keep no such counter: one kernel runs both.
LONG_LANES = [("small_byte", 127 * 65535 + 1, False), ("small_byte", 24 << 20, True),
              ("small_nybble", 64 * 65535 + 1, False), ("small_nybble", 16 << 20, True)]


@pytest.mark.parametrize("kind,S,past", LONG_LANES)
def test_small_lanes_on_long_blocks_match_the_native_runtime(cuda, kind, S, past):
    blocks = long_small_blocks(S, 98)
    lengths = np.full(3, S, np.int64)
    keep, raws, payloads = _native_payloads(kind, blocks, lengths)
    assert keep == ([0, 1] if kind == "small_byte" else [0, 1, 2])
    rows, totals, status = lanes.ENCODERS[kind](torch.from_numpy(blocks).to(cuda),
                                                torch.from_numpy(lengths).to(cuda))
    assert status.cpu().tolist() == [lanes.OK if i in keep else lanes.INPUT for i in range(3)]
    tot = totals.cpu().numpy()
    assert [rows[i, : tot[i]].cpu().numpy().tobytes() for i in keep] == payloads
    slots = 128 if kind == "small_nybble" else 127
    writes = (len(payloads[0]) - 3) // slots  # words after the first, all into context 1
    assert (writes > 65535) == past
    out, st = lanes.DECODERS[kind](*_lane_flat(payloads, cuda),
                                   torch.from_numpy(lengths[keep].astype(np.int32)).to(cuda), S)
    assert st.cpu().tolist() == [lanes.OK] * len(keep)
    out = out.cpu().numpy()
    assert [out[k].tobytes() for k in range(len(keep))] == raws


@pytest.mark.parametrize("kind", LANE_KINDS)
@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_lane_occupancy_reads_the_launch(cuda, kind, direction):
    """Each lane kernel's occupancy: at least one CTA an SM, whole blocks a
    CTA; every lane holds every one of 1,026 blocks (64 MiB at 64 KiB and
    the two edge blocks) in one wave."""
    occ = lanes.lane_occupancy(f"{kind}_{direction}")
    assert occ["ctas_per_sm"] >= 1 and occ["blocks_per_cta"] >= 1
    assert occ["threads_per_cta"] % occ["blocks_per_cta"] == 0 and occ["smem_per_cta"] > 0
    assert occ["layout"] == lanes.layout_text(occ["threads_per_cta"], occ["blocks_per_cta"],
                                              occ["smem_per_cta"])
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert occ["ctas_per_sm"] * occ["blocks_per_cta"] * sms >= 1026


@pytest.mark.parametrize("S", [1, 4097, 65536, 1 << 20])
def test_nybble_lanes_match_the_native_drivers(cuda, S):
    """The nybble lanes byte for byte against the native drivers on the
    rows of ``lane_blocks`` (lengths 0, 1, 2 and below S, bytes >= 0x80,
    one byte value) and on rows whose every step has one context (bytes
    8-15: context 1, the encoder's whole block one chain), at the
    wrappers' row width S + 2, exactly n + 2 for a full row: statuses,
    totals and payloads; then the decode of the native payloads."""
    blocks, lengths = lane_blocks("nybble", S, 101)
    one = np.random.default_rng(102).integers(8, 16, (2, S), dtype=np.uint8)
    blocks = np.concatenate([blocks, one])
    lengths = np.concatenate([lengths, [S, max(S - 5, 0)]])
    keep, raws, payloads = _native_payloads("nybble", blocks, lengths)
    rows, totals, status = lanes.nybble_encode(torch.from_numpy(blocks).to(cuda),
                                               torch.from_numpy(lengths).to(cuda))
    assert rows.shape[1] == S + 2
    assert status.cpu().tolist() == [lanes.OK if i in keep else lanes.INPUT
                                     for i in range(len(lengths))]
    tot, rows = totals.cpu().numpy(), rows.cpu().numpy()
    assert [rows[i, : tot[i]].tobytes() for i in keep] == payloads
    out, st = lanes.nybble_decode(*_lane_flat(payloads, cuda),
                                  torch.tensor([len(r) for r in raws], dtype=torch.int32,
                                               device=cuda), S)
    assert st.cpu().tolist() == [lanes.OK] * len(keep)
    out = out.cpu().numpy()
    assert [out[k, : len(r)].tobytes() for k, r in enumerate(raws)] == raws


def test_nybble_decode_lane_matches_the_native_runtime_on_crafted_and_random_payloads(cuda):
    """64 KiB rows of ``corpora.payload_mix``: token streams ending at the
    body's end, one step past it, or with a literal whose second nybble
    lies just past it; real payloads with flipped bytes or cut short;
    random bodies: statuses and OK rows equal the native decoder's."""
    S = 65536
    real = native.nybble_encode(enwik_like(S, 98))
    payloads, raws = payload_mix("nybble", S, 64, 99, real)
    out, st = lanes.nybble_decode(*_lane_flat(payloads, cuda),
                                  torch.tensor(raws, dtype=torch.int32, device=cuda), S)
    assert 0 < decoded_as_native("nybble", payloads, raws, out, st) < len(payloads)


def _guarded(n, fill, dev):
    """(canvas, its middle n bytes) with GUARD bytes of ``fill`` each side."""
    canvas = torch.full((n + 2 * GUARD,), fill, dtype=torch.uint8, device=dev)
    return canvas, canvas[GUARD: GUARD + n]


def _guards_intact(canvas, fill):
    return bool((canvas[:GUARD] == fill).all()) and bool((canvas[-GUARD:] == fill).all())


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_lane_encoders_keep_to_their_rows(cuda, kind):
    """Rows of exactly the worst case's width, and one byte narrower
    (full rows then report CAPACITY), inside guard bytes."""
    S = 4096
    blocks, lengths = lane_blocks(kind, S, 92)
    B = blocks.shape[0]
    dev_blocks = torch.from_numpy(blocks).to(cuda)
    dev_lens = torch.from_numpy(lengths.astype(np.int32)).to(cuda)
    want_rows, want_totals, want_status = lanes.ENCODERS[kind](dev_blocks, dev_lens)
    W = lanes.row_width(kind, S)
    for width in (W, W - 1):
        canvas, rows = _guarded(B * width, 0xA5, cuda)
        totals = torch.empty(B, dtype=torch.int32, device=cuda)
        status = torch.empty(B, dtype=torch.int32, device=cuda)
        args = (dev_blocks.data_ptr(), S, dev_lens.data_ptr(), rows.data_ptr(), width,
                totals.data_ptr(), status.data_ptr(), B, _build.stream_of(dev_blocks))
        if kind == "nybble":
            rc = _build.lib().dct_nybble_encode(*args)
        else:
            rc = _build.lib().dct_small_encode(int(kind == "small_nybble"), *args)
        _build.check(rc, "encode lane")
        torch.cuda.synchronize()
        assert _guards_intact(canvas, 0xA5)
        full = torch.from_numpy(lengths == S).to(cuda)
        expect = torch.where(full & (width < W), lanes.CAPACITY, want_status)
        assert torch.equal(status, expect)
        rows = rows.view(B, width)
        for i in range(B):
            if int(expect[i]) == lanes.OK:
                n = int(want_totals[i])
                assert int(totals[i]) == n and torch.equal(rows[i, :n], want_rows[i, :n])


def _random_payloads(kind, B, seed):
    rng = np.random.default_rng(seed)
    type_byte = psc.TYPE_BYTE[kind]
    payloads = []
    for _ in range(B):
        body = rng.integers(0, 256, int(rng.integers(0, 3000)), dtype=np.uint8).tobytes()
        payloads.append(bytes([type_byte if rng.random() < 0.9 else 0x41]) + body)
    return payloads, rng.integers(0, 4097, B).astype(np.int32)


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_lane_decoders_keep_to_their_rows(cuda, kind):
    """Random payload bytes (and real ones; for the small decoders also
    crafted spans whose sources end where they are written, filling the
    row): between guard fills 0x00 and 0xFF around the payloads and the
    output rows, the status and every decoded row come out the same, as
    the plain version's, and no guard byte changes."""
    S = 4096
    blocks, lengths = lane_blocks(kind, S, 95)
    _, raws, real = _native_payloads(kind, blocks, lengths)
    payloads, raw = _random_payloads(kind, 54, 96)
    payloads += real
    raw = np.concatenate([raw, [len(r) for r in raws]]).astype(np.int32)
    if kind != "nybble":
        crafted = [tight_span_payload(kind, S, seed) for seed in (0, 1)]
        payloads += [p for p, _ in crafted]
        raw = np.concatenate([raw, [n for _, n in crafted]]).astype(np.int32)
    B = len(payloads)
    flat_c, offs, plens = _lane_flat(payloads, "cpu")
    raw_c = torch.from_numpy(raw)
    want_out, want_st = lanes.DECODERS[kind](flat_c, offs, plens, raw_c, S)
    assert {int(s) for s in want_st} == {lanes.OK, lanes.FORMAT}
    seen = []
    for fill in (0x00, 0xFF):
        flat_canvas, flat = _guarded(flat_c.numel(), fill, cuda)
        flat.copy_(flat_c)
        out_canvas, out = _guarded(B * S, fill, cuda)
        status = torch.empty(B, dtype=torch.int32, device=cuda)
        lib = _build.lib()
        dev_offs, dev_plens, dev_raw = offs.to(cuda), plens.to(cuda), raw_c.to(cuda)
        common = (flat.data_ptr(), flat.numel(), dev_offs.data_ptr(), dev_plens.data_ptr(),
                  dev_raw.data_ptr())
        if kind == "nybble":
            rc = lib.dct_nybble_decode(*common, out.data_ptr(), S, status.data_ptr(), B,
                                       _build.stream_of(flat))
        else:
            rc = lib.dct_small_decode(int(kind == "small_nybble"), *common, out.data_ptr(), S,
                                      status.data_ptr(), B, _build.stream_of(flat))
        _build.check(rc, "decode lane")
        torch.cuda.synchronize()
        for canvas in (flat_canvas, out_canvas):
            assert _guards_intact(canvas, fill)
        assert torch.equal(status.cpu(), want_st)
        out = out.view(B, S).cpu()
        rows = [out[i, : raw[i]] for i in range(B) if int(want_st[i]) == lanes.OK]
        for i in range(B):
            if int(want_st[i]) == lanes.OK:
                assert torch.equal(out[i, : raw[i]], want_out[i, : raw[i]]), i
        seen.append(rows)
    assert all(torch.equal(a, b) for a, b in zip(*seen))


def _small_decode_against_native(kind, payloads, raws, S, dev):
    """The small decoder of ``kind`` on ``payloads`` against the native
    decoder block by block: equal statuses, equal OK rows; -> OK blocks."""
    out, st = lanes.DECODERS[kind](*_lane_flat(payloads, dev),
                                   torch.tensor(raws, dtype=torch.int32, device=dev), S)
    return decoded_as_native(kind, payloads, raws, out, st)


SMALL_KINDS = ("small_byte", "small_nybble")
# the small decoders' narrow dictionary layout holds blocks of up to 2^19
# symbols (csrc/small_lanes.cu kNarrowSymbols); longer ones take the wide
NARROW_MAX = {"small_byte": 1 << 19, "small_nybble": 1 << 18}


@pytest.mark.parametrize("kind", SMALL_KINDS)
def test_small_decode_lanes_match_the_native_runtime_on_crafted_and_random_payloads(cuda, kind):
    """64 KiB rows of ``corpora.payload_mix``: crafted streams of
    the deepest words (spans whose sources end exactly where they are
    written, up to 361 / 511 symbols, sources inside the copier's round
    of 32), the same cut one or two symbols short, real payloads with
    flipped bytes or cut short, and random bodies: statuses and OK rows
    equal the native decoder's."""
    S = 65536
    real = getattr(native, f"{kind}_encode")(enwik_like(S, 98))
    payloads, raws = payload_mix(kind, S, 48, 99, real)
    assert 0 < _small_decode_against_native(kind, payloads, raws, S, cuda) < len(payloads)


@pytest.mark.parametrize("kind", SMALL_KINDS)
@pytest.mark.parametrize("past", [False, True])
def test_small_decode_lanes_on_both_sides_of_the_narrow_bound(cuda, kind, past):
    """Blocks of the narrow layout's largest size (6-byte dictionary
    slots) and one byte more (the wide layout, 8 bytes a slot): crafted
    deepest words, whose entries reach 1,023 symbols and start near the
    block's end, text and one byte value equal the native decoder's; the
    occupancy query reads the layout the launch takes."""
    S = NARROW_MAX[kind] + past
    payloads, raws = [], []
    for seed in (0, 1):
        p, n = tight_span_payload(kind, S, seed)
        payloads.append(p)
        raws.append(n)
    for raw in (enwik_like(S, 97), b"a" * S):
        payloads.append(getattr(native, f"{kind}_encode")(raw))
        raws.append(len(raw))
    assert _small_decode_against_native(kind, payloads, raws, S, cuda) == len(payloads)
    narrow = lanes.lane_occupancy(f"{kind}_decode", S - past)
    this = lanes.lane_occupancy(f"{kind}_decode", S)
    assert (this["smem_per_cta"] > narrow["smem_per_cta"]) == past


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_serial_lanes_make_no_host_read(cuda, kind):
    """Between the upload and the downloads (the totals and status, then
    the payload bytes; the rows and status) neither the lanes nor the
    compaction given the total read back: each runs under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    blocks, lengths = lane_blocks(kind, 4096, 97)
    dev_blocks = torch.from_numpy(blocks).to(cuda)
    dev_lens = torch.from_numpy(lengths.astype(np.int32)).to(cuda)

    def no_sync(fn, *args, **kw):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    rows, totals, status = no_sync(lanes.ENCODERS[kind], dev_blocks, dev_lens)
    tot = totals.cpu().numpy()
    flat = no_sync(kcmp.compact_blocks, rows, totals, total=int(tot.sum())).cpu().numpy()
    want = psc.encode_payloads(kind, blocks, lengths, "cpu")
    ends = np.cumsum(tot)
    st = status.cpu().numpy()
    for i in range(len(tot)):
        if st[i] == lanes.OK:
            assert flat[ends[i] - tot[i]: ends[i]].tobytes() == want[i]
    keep, raws, payloads = _native_payloads(kind, blocks, lengths)
    args = _lane_flat(payloads, cuda) + (
        torch.from_numpy(lengths[keep].astype(np.int32)).to(cuda), 4096)
    out, st = no_sync(lanes.DECODERS[kind], *args)
    assert st.cpu().tolist() == [lanes.OK] * len(keep)
    out = out.cpu().numpy()
    assert [out[k, : len(r)].tobytes() for k, r in enumerate(raws)] == raws


def test_serial_lane_wrappers_reject_bad_cuda_inputs(cuda):
    blocks = torch.zeros((2, 8), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        lanes.small_byte_decode(blocks[0], torch.zeros(2, dtype=torch.int64),
                                torch.zeros(2, dtype=torch.int32, device=cuda),
                                torch.zeros(2, dtype=torch.int32, device=cuda), 8)
    with pytest.raises(ValueError, match="integers"):
        lanes.nybble_encode(blocks, torch.zeros(2, device=cuda))
