"""The plain reference: its encoder and decoder round-trip, and they agree
with the program's plain versions (a test may import the program; the
reference may not)."""

import subprocess
import sys

import pytest
import torch

from portbench import corpus
from portbench.reference import huffman as ref
from portbench.spec import ROOT

from data_compression_tpu_torch.ops.kernels import compact as kcompact
from data_compression_tpu_torch.ops.kernels import decode as kdecode
from data_compression_tpu_torch.ops.kernels import encode as kencode
from data_compression_tpu_torch.ops.kernels.histogram import block_histograms_ref
from data_compression_tpu_torch.ops.kernels.table_build import build_tables_ref, huffman_lengths_ref
from data_compression_tpu_torch.ops.table_build import decode_tables_device
from data_compression_tpu_torch.utils import corpora

CAP = 15
C = 512


def _blocks(seed, B=3, S=4096):
    """Text blocks with one deep-code block, the last block cut short."""
    raw = corpus.make_buffers({"text": "enwik_like", "deep_block_every": B}, 1, B, S, seed,
                              "cpu")[0]
    lens = torch.full((B,), S, dtype=torch.int32)
    lens[-1] = S - 777
    return raw, lens


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_round_trip(n, seed):
    raw, lens = _blocks(seed)
    lengths = ref.code_lengths(ref.histograms(raw, lens), n, CAP)
    payload, chunk_bytes = ref.encode(raw, lens, lengths, n, C)
    B, S = raw.shape
    first = torch.arange(S // C)[None, :] * C
    counts = (lens.long()[:, None] - first).clamp(0, C)
    out = ref.decode(payload, chunk_bytes, counts, lengths, n, C, CAP)
    valid = torch.arange(S)[None, :] < lens.long()[:, None]
    assert torch.equal(torch.where(valid, out, 0), torch.where(valid, raw, 0))
    assert int(lengths.max()) <= CAP


@pytest.mark.parametrize("n", [2, 3])
def test_agrees_with_the_programs_plain_versions(n):
    raw, lens = _blocks(9)
    hist = ref.histograms(raw, lens)
    assert torch.equal(hist, block_histograms_ref(raw, lens))
    lengths = ref.code_lengths(hist, n, CAP)
    assert torch.equal(lengths, huffman_lengths_ref(hist, n))
    payload, chunk_bytes = ref.encode(raw, lens, lengths, n, C)
    _, dense = build_tables_ref(hist, n)
    rows, digits, block_bytes = kencode.encode_blocks_ref(raw, lens, dense, C, n)
    D = {2: 8, 3: 5}[n]
    assert torch.equal(chunk_bytes.long(), ((digits + D - 1) // D).long())
    assert torch.equal(payload, kcompact.compact_blocks_ref(rows, block_bytes))
    # the program's plain decode reads the reference's payload
    B, S = raw.shape
    off = torch.cat([torch.zeros(1, dtype=torch.int64),
                     torch.cumsum(chunk_bytes.view(-1).long(), 0)])
    first = torch.arange(S // C)[None, :] * C
    cnt = (lens.long()[:, None] - first).clamp(0, C).to(torch.int32).view(-1)
    blk = (torch.arange(B * (S // C)) // (S // C)).to(torch.int32)
    limit, bmf, symbols = decode_tables_device(lengths.to(torch.uint8), n)
    out = kdecode.decode_chunks_ref(payload, off, cnt, blk, limit, bmf, symbols, C, n).view(B, S)
    valid = torch.arange(S)[None, :] < lens.long()[:, None]
    assert torch.equal(torch.where(valid, out, 0), torch.where(valid, raw, 0))


def test_deep_block_reaches_the_cap_at_n2():
    raw = torch.empty(65536, dtype=torch.uint8)
    corpus.deep_code_block(raw, torch.Generator().manual_seed(3))
    lengths = ref.code_lengths(ref.histograms(raw[None], torch.tensor([65536])), 2, CAP)
    assert int(lengths.max()) == CAP


def test_corpus_is_the_programs_cdf_and_seeded():
    assert bytes(corpus.ENWIK_ALPHABET) == corpora.ENWIK_ALPHABET.tobytes()
    assert list(corpus.ENWIK_WEIGHTS) == corpora.ENWIK_WEIGHTS.tolist()
    cfg = {"text": "enwik_like", "deep_block_every": 2}
    a = corpus.make_buffers(cfg, 2, 3, 4096, 2**33 + 1, "cpu")
    b = corpus.make_buffers(cfg, 2, 3, 4096, 2**33 + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    deep = [int((blk < 16).all()) for blk in a[0]]
    assert sum(deep) == 2  # one in each group of two blocks, the last group shorter


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import portbench.reference.huffman; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    names = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                           check=True).stdout
    for bad in ("'data_compression_tpu_torch'", "'data_compression_tpu'", "'jax'", "'jaxlib'"):
        assert bad not in names
