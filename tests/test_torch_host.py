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
from data_compression_tpu_torch.ops.kernels.histogram import block_histograms
from data_compression_tpu_torch.utils.corpora import deep_code_block, enwik_like
from torch_cases import hist_blocks

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
        "import data_compression_tpu_torch.native\n"
        "import data_compression_tpu_torch.models.literal\n"
        "import data_compression_tpu_torch.models.nybble\n"
        "import data_compression_tpu_torch.models.small\n"
        "import data_compression_tpu_torch.utils.debug\n"
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


def test_serial_codec_constants_match():
    """The serial modules' wire constants, tables and dictionary defaults
    equal the originals'."""
    import data_compression_tpu.models.nybble as jnyb
    import data_compression_tpu.models.small as jsmall
    import data_compression_tpu_torch.models.nybble as pnyb
    import data_compression_tpu_torch.models.small as psmall

    for name in ("NYBBLES_TYPE", "SEED_ROW", "NUM_CONTEXTS", "LETTERS_PER_CONTEXT"):
        assert getattr(pnyb, name) == getattr(jnyb, name), name
    assert pnyb._new_table() == jnyb._new_table()
    for name in ("EIGHT_BIT_PRUNED", "ISPRINT_LITERAL", "NUM_CONTEXTS", "DICT_INDEXES",
                 "MAX_WORD", "NP_SLOTS", "WORD_INDEXES"):
        assert getattr(psmall, name) == getattr(jsmall, name), name
    np.testing.assert_array_equal(psmall._NP_BYTES, jsmall._NP_BYTES)
    np.testing.assert_array_equal(psmall._NP_SLOT, jsmall._NP_SLOT)
    for n_slots in (jsmall.DICT_INDEXES, jsmall.NP_SLOTS):
        pd, jd = psmall._ByteDict(n_slots), jsmall._ByteDict(n_slots)
        for f in ("start", "length", "gen", "prefix", "prefix_gen", "letter", "nwi"):
            np.testing.assert_array_equal(getattr(pd, f), getattr(jd, f))
    pt_, jt = psmall._NybbleTable(), jsmall._NybbleTable()
    for f in ("start", "length", "gen", "prefix", "prefix_gen", "letter", "nwi"):
        np.testing.assert_array_equal(getattr(pt_, f), getattr(jt, f))
    for x in range(256):
        assert psmall._is_literal_index(x) == jsmall._is_literal_index(x)
        assert psmall._ctx(x) == jsmall._ctx(x) and pnyb._ctx(x) == jnyb._ctx(x)


def test_debug_utils_match():
    """utils/debug.py: C literals and strings, the table dumps, the decode
    trace and the stats counters equal the originals'."""
    import data_compression_tpu.models.nybble as jnyb
    import data_compression_tpu.models.small as jsmall
    import data_compression_tpu.utils.debug as jdbg
    import data_compression_tpu_torch.models.small as psmall
    import data_compression_tpu_torch.utils.debug as pdbg

    rng = np.random.default_rng(17)
    blob = bytes(rng.integers(0, 256, 600, dtype=np.uint8)) + b'a"\\\n\tf0' * 30
    for width in (70, 12):
        assert pdbg.c_literal(blob, width) == jdbg.c_literal(blob, width)
    assert pdbg.c_string(blob, "x") == jdbg.c_string(blob, "x")
    text = enwik_like(3000, 18)
    table = jnyb._new_table()
    for i in range(1, len(text)):
        jnyb._mtf_update(table, jnyb._ctx(text[i - 1]), text[i])
    assert pdbg.dump_nybble_table(table) == jdbg.dump_nybble_table(table)
    payload = jnyb.encode_host(text)
    assert list(pdbg.trace_nybble_decode(payload, len(text))) == list(
        jdbg.trace_nybble_decode(payload, len(text)))
    d = psmall._ByteDict()
    for i in range(1, 200):
        d.add(i % 32, 0x41, i - 1, i % 7, text[i])
    assert pdbg.dump_small_dictionary(d, text) == jdbg.dump_small_dictionary(d, text)
    assert pdbg.dump_small_dictionary(d, text, 5) == jdbg.dump_small_dictionary(d, text, 5)
    assert pdbg.dump_small_dictionary(psmall._ByteDict(), b"") == jdbg.dump_small_dictionary(
        jsmall._ByteDict(), b"")
    ps, js = pdbg.CodecStats(32), jdbg.CodecStats(32)
    assert ps.summary() == js.summary()
    for s in (ps, js):
        for k in range(100):
            s.hit(k % 32) if k % 3 else s.literal()
    assert (ps.summary(), ps.times_used_directly, ps.hits, ps.literals) == (
        js.summary(), js.times_used_directly, js.hits, js.literals)


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


@pytest.mark.parametrize("kind", ["enwik", "single", "empty_row", "zero_and_255", "edge_lengths",
                                  "s4104", "odd_offset", "period16"])
def test_block_histograms_match(kind):
    """The port's histogram (on the CPU its plain version) equals the JAX
    package's one-hot matmul (run on the CPU) and numpy, with padding
    dropped: text, one byte value, random bytes, all-0 and all-255 rows,
    lengths 0, 1, S-1 and S, S = 4104 (no multiple of 16), a row view
    at an odd offset of a flat buffer, and a 16-byte record repeated."""
    from data_compression_tpu.ops.histogram import block_histograms as j_hist

    rng = np.random.default_rng(3)
    B, S = 3, 4096
    lengths = np.array([S, 1234, 0], np.int64)
    if kind == "enwik":
        blocks = np.frombuffer(enwik_like(B * S, 9), np.uint8).reshape(B, S).copy()
    elif kind == "single":
        blocks = np.full((B, S), 200, np.uint8)
    elif kind == "period16":
        blocks = hist_blocks("period16", B, S, 4)[0]
    elif kind == "empty_row":
        blocks = rng.integers(0, 256, (B, S), dtype=np.uint8)
    elif kind == "zero_and_255":
        blocks = np.stack([np.zeros(S, np.uint8), np.full(S, 255, np.uint8),
                           np.zeros(S, np.uint8)])
        lengths = np.array([S, S, 17], np.int64)
    else:
        if kind == "s4104":
            S = 4104
        B = 5
        lengths = np.array([0, 1, S - 1, S, 777], np.int64)
        blocks = hist_blocks("edges", B, S, 4)[0]
    view = torch.from_numpy(blocks)
    if kind == "odd_offset":
        flat = torch.zeros(B * S + 1, dtype=torch.uint8)
        flat[1:] = view.reshape(-1)
        view = flat[1:].view(B, S)
        assert view.data_ptr() % 2 == 1
    got = block_histograms(view, torch.from_numpy(lengths)).numpy()
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


@pytest.mark.parametrize("shared", [False, True])
def test_every_cut_through_the_block_table_raises(shared):
    """A frame cut at any offset up to the end of its block table (the
    header, the shared-table length and table, every table entry) raises
    ValueError from each reader; at offset 0 ``read_frame`` sees a clean
    end of stream."""
    import data_compression_tpu_torch as pt

    frame = pt.compress(enwik_like(3 * 4096 + 700, 21),
                        PConfig(block_size=4096, chunk_syms=512, shared_table=shared),
                        device="cpu")
    f = pframing.unpack_frame(frame)
    end = len(frame) - sum(e.comp_len for e in f.entries)  # the first payload byte
    assert end == 32 + (4 + len(f.shared_table) if shared else 0) + 4 * 16  # 4 blocks
    assert pframing.read_frame(io.BytesIO(b"")) is None
    for cut in range(end + 1):
        with pytest.raises(ValueError):
            pframing.unpack_frame(frame[:cut])
        if cut:
            with pytest.raises(ValueError):
                pframing.read_frame(io.BytesIO(frame[:cut]))
        with pytest.raises(ValueError):
            pt.decompress(frame[:cut], device="cpu")


def _with_codec_id(frame: bytes, codec_id: int) -> bytes:
    """``frame`` with its header's codec id replaced and the header CRC
    recomputed."""
    head = bytearray(frame[:28])
    head[8] = codec_id
    return bytes(head) + pframing.crc32(bytes(head)).to_bytes(4, "little") + frame[32:]


def test_unknown_codec_id_raises(tmp_path):
    import data_compression_tpu_torch as pt
    from data_compression_tpu_torch import cli

    frame = pt.compress(enwik_like(5000, 22), PConfig(block_size=4096), device="cpu")
    bad = _with_codec_id(frame, 99)
    assert pframing.unpack_frame(_with_codec_id(frame, 4)).codec_name == "huffman"
    with pytest.raises(ValueError, match="codec id 99"):
        pframing.unpack_frame(bad)
    with pytest.raises(ValueError, match="codec id 99"):
        pframing.read_frame(io.BytesIO(bad))
    with pytest.raises(ValueError, match="codec id 99"):
        pt.decompress(bad, device="cpu")
    path = tmp_path / "bad.dctz"
    path.write_bytes(bad)
    with pytest.raises(ValueError, match="codec id 99"):
        cli.main(["info", str(path)])


def test_split_blocks_match():
    for n in (0, 1, 4095, 4096, 4097, 10000):
        data = bytes(np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8))
        bj, lj = jframing.split_blocks(data, 4096)
        bp, lp = pframing.split_blocks(data, 4096)
        np.testing.assert_array_equal(bp, bj)
        np.testing.assert_array_equal(lp, lj)


def test_printable_container_not_ported():
    """The printable container, once the one part of framing left
    unported, is now read as the JAX package reads it: ``unpack_frame``
    rejects the printable bytes with the original's ValueError, and
    ``read_frame`` / ``printable_to_frame`` give the original's binary
    frame, which ``frame_to_printable`` turns back into the same text."""
    from data_compression_tpu import compress as jcompress

    blob = jcompress(b"hello world " * 50,
                     JConfig(block_size=4096, use_device=False), printable=True)
    errors = []
    for unpack in (jframing.unpack_frame, pframing.unpack_frame):
        with pytest.raises(ValueError) as e:
            unpack(blob)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "bad magic b'DCTP'"
    binary = jframing.read_frame(io.BytesIO(blob))
    assert pframing.read_frame(io.BytesIO(blob)) == binary
    assert pframing.printable_to_frame(blob) == binary
    assert pframing.frame_to_printable(binary) == blob
