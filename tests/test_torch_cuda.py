"""CUDA kernels on the card: each kernel against its plain version on
the same CUDA tensors, and the slice on ``cuda`` against the port's CPU
path.  Marked ``cuda``; every test skips where no CUDA device is
available (decided inside the fixture, never at import).  Run on a GPU
machine with ``python -m pytest tests/test_torch_cuda.py -m cuda``.

Tolerance: exact — valid output bytes must be equal.
"""

import numpy as np
import pytest
import torch

import data_compression_tpu_torch as pt
from data_compression_tpu_torch import framing
from data_compression_tpu_torch.huffman.batched import to_device
from data_compression_tpu_torch.models.huffman import HuffmanCodec
from data_compression_tpu_torch.ops.kernels import compact as kcmp
from data_compression_tpu_torch.ops.kernels import decode as kdec
from data_compression_tpu_torch.ops.kernels import encode as kenc
from data_compression_tpu_torch.utils.corpora import deep_code_block, enwik_like

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _data():
    # 7 enwik-like blocks, one deep-code block, a partial last block
    return enwik_like(7 * 65536, 61) + deep_code_block(65536, 62) + enwik_like(3000, 63)


@pytest.mark.parametrize("chunk_syms", [512, 128])
def test_kernels_match_plain_versions(cuda, chunk_syms):
    cfg = pt.CodecConfig(chunk_syms=chunk_syms)
    codec = HuffmanCodec(cfg, cuda)
    blocks, lengths = framing.split_blocks(_data(), cfg.block_size)
    dev_blocks, dev_lens = codec.upload_blocks(blocks, lengths)
    tb, _ = codec.tables(dev_blocks, dev_lens)
    dense = to_device(tb, cuda)["dense"]

    rows, digits, bb = kenc.encode_blocks(dev_blocks, dev_lens, dense, chunk_syms)
    rows_r, digits_r, bb_r = kenc.encode_blocks_ref(dev_blocks, dev_lens, dense, chunk_syms)
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


@pytest.mark.parametrize("shared", [False, True])
def test_slice_on_cuda_matches_cpu(cuda, shared):
    x = _data()
    cfg = pt.CodecConfig(shared_table=shared)
    counts = [f.launches for f in (kenc.encode_blocks, kcmp.compact_blocks, kdec.decode_chunks)]
    frame = pt.compress(x, cfg, device=cuda)
    assert frame == pt.compress(x, cfg, device="cpu")
    assert pt.decompress(frame, device=cuda) == x
    after = [f.launches for f in (kenc.encode_blocks, kcmp.compact_blocks, kdec.decode_chunks)]
    assert all(a > c for a, c in zip(after, counts))


def test_corrupt_frame_raises_on_cuda(cuda):
    x = enwik_like(3 * 4096, 64)
    cfg = pt.CodecConfig(block_size=4096, chunk_syms=512)
    stream = bytearray(pt.compress(x, cfg, device=cuda))
    rng = np.random.default_rng(9)
    body = len(stream) - sum(e.comp_len for e in framing.unpack_frame(bytes(stream)).entries)
    for pos in rng.integers(body, len(stream), 8):
        corrupt = bytearray(stream)
        corrupt[int(pos)] ^= 0xFF
        with pytest.raises(ValueError):
            pt.decompress(bytes(corrupt), device=cuda)


def test_wrappers_reject_bad_cuda_inputs(cuda):
    blocks = torch.zeros((2, 1024), dtype=torch.uint8, device=cuda)
    lens = torch.full((2,), 1024, dtype=torch.int32, device=cuda)
    dense = torch.zeros((2, 256), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kenc.encode_blocks(blocks[:, ::2], lens, dense, 256)  # not contiguous
    with pytest.raises(ValueError):
        kenc.encode_blocks(blocks, lens.cpu(), dense, 512)  # mixed devices
    rows = torch.zeros((2, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        kcmp.compact_blocks(rows, torch.tensor([65, 0], dtype=torch.int32, device=cuda))
    z = torch.zeros((1, 16), dtype=torch.int32, device=cuda)
    args = dict(flat=torch.zeros(4, dtype=torch.uint8, device=cuda),
                chunk_off=torch.tensor([0, 8], dtype=torch.int64, device=cuda),  # past flat
                chunk_cnt=torch.tensor([16], dtype=torch.int32, device=cuda),
                chunk_blk=torch.zeros(1, dtype=torch.int32, device=cuda),
                limit=z, bmf=z, symbols=torch.zeros((1, 256), dtype=torch.int32, device=cuda),
                chunk_syms=16)
    with pytest.raises(ValueError):
        kdec.decode_chunks(**args)
