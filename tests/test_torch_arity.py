"""Huffman n = 16 and n = 3 through the port's kernel modules (their
plain versions on the CPU), and the host path of the other arities,
against the JAX package:

  * the plain encode (compact and per-chunk rows) against the TPU kernels
    ``_encode_pallas_compact`` / ``_encode_pallas`` in Pallas interpret
    mode and against the JAX host encoder;
  * the plain decode against ``decode_blocks_pallas`` in interpret mode,
    with a complete code tree (last limit exactly n**L) and a chunk of
    L-digit codes;
  * ``compress`` frames against ``jx.compress`` (host path), cross-decode
    both ways (the JAX device path too), corrupt frames, the sharded
    pipeline in a gloo world of one;
  * arities 4, 9 and 10 on the host path, against the JAX host path.

Inputs are made from seeds with numpy.  Tolerance: exact (bytes).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import data_compression_tpu as jx
import data_compression_tpu.huffman.batched as jhb
from data_compression_tpu.models.huffman import encode_chunk_np as jax_encode_chunk
from data_compression_tpu.parallel import mesh as jmesh
from data_compression_tpu.parallel import pipeline as jpipe

import data_compression_tpu_torch as pt
import data_compression_tpu_torch.huffman.batched as phb
from data_compression_tpu_torch import cli as pcli
from data_compression_tpu_torch import framing
from data_compression_tpu_torch.config import ARITY_MAX_LEN, max_chunk_bytes, wire_bytes
from data_compression_tpu_torch.models import huffman as phuff
from data_compression_tpu_torch.ops.kernels import decode as kdec
from data_compression_tpu_torch.ops.kernels import encode as kenc
from data_compression_tpu_torch.parallel import compress_sharded, decompress_sharded, make_mesh
from data_compression_tpu_torch.utils.corpora import complete_lengths, deep_code_block, enwik_like

ARITIES = [16, 3]
# symbols of a complete tree: 1 + a multiple of n-1 (all 256 at n=16)
N_SYMBOLS = {16: 256, 3: 255}
GENERIC = [4, 9, 10]


def _blocks(n, S, C, seed):
    """Three blocks [3, S] and their tables: an enwik-like block, a short
    one, and a block coded with a complete tree of depth L whose chunk 0
    holds only L-digit codes.  -> (data, raw_lens, JAX tables, port tables)."""
    L = ARITY_MAX_LEN[n]
    rng = np.random.default_rng(seed)
    data = np.zeros((3, S), np.uint8)
    data[:2] = np.frombuffer(enwik_like(2 * S, seed), np.uint8).reshape(2, S)
    data[2] = rng.integers(0, N_SYMBOLS[n], S)
    raw_lens = np.array([S, S - 3 * C - 7, S], np.int64)
    data[1, raw_lens[1]:] = 0
    hists = np.stack([np.bincount(data[b, : raw_lens[b]], minlength=256) for b in range(2)])
    lengths = np.zeros((3, 256), np.int32)
    lengths[:2] = jhb.capped_lengths_batch(hists.astype(np.int64), n)
    lengths[2] = complete_lengths(n, L, N_SYMBOLS[n])
    deep = np.flatnonzero(lengths[2] == L)
    data[2, :C] = deep[np.arange(C) % deep.size]
    tj = jhb.codes_batch(lengths, n)
    return data, raw_lens, tj, phb.TableBatch.from_arrays(dataclasses.asdict(tj))


def _chunks(data, raw_lens, tj, C):
    out = []
    for b, r in enumerate(raw_lens):
        out.append([
            jax_encode_chunk(data[b, c * C : c * C + max(0, min(C, int(r) - c * C))], tj.table(b))
            for c in range(max(1, -(-int(r) // C)))
        ])
    return out


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a if dtype is None else np.asarray(a, dtype)))


def _port_decode(tp, chunks, raw_lens, C, n):
    tabs = phb.decode_tensors(tp, "cpu")
    flat = np.frombuffer(b"".join(c for blk in chunks for c in blk) or b"\0", np.uint8).copy()
    off = np.concatenate([[0], np.cumsum([len(c) for blk in chunks for c in blk])])
    cnt = [max(0, min(C, int(r) - c * C)) for r, blk in zip(raw_lens, chunks) for c in range(len(blk))]
    blk = np.repeat(np.arange(len(chunks), dtype=np.int32), [len(b) for b in chunks])
    out = kdec.decode_chunks(
        _t(flat), _t(off, np.int64), _t(cnt, np.int32), _t(blk), tabs["limit"], tabs["bmf"],
        tabs["symbols"], C, n,
    ).numpy()
    res, k = [], 0
    for r, b in zip(raw_lens, chunks):
        res.append(out[k : k + len(b)].reshape(-1)[: int(r)].tobytes())
        k += len(b)
    return res


# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize("n", ARITIES)
def test_encode_ref_matches_pallas_kernels(n):
    """C=128 (16 KiB blocks): compact rows equal ``_encode_pallas_compact``
    and per-chunk rows equal ``_encode_pallas`` (interpret mode), with a
    chunk of L-digit codes that fills its whole row.

    The complete-tree block is held against the JAX package's host
    encoder and rows kernel instead of the compact kernel: in interpret
    mode the compact kernel writes the first bytes of a few of its chunks
    differently from both (a fault of the reference kernel, recorded in
    ROADMAP.md)."""
    import jax.numpy as jnp

    from data_compression_tpu.ops.pallas.encode_kernel import (
        LANES, _encode_pallas_compact, encode_blocks_pallas,
    )

    C = 128
    S = C * LANES
    data, raw_lens, tj, tp = _blocks(n, S, C, 80 + n)
    dense = phb.encode_tensors(tp, "cpu")["dense"]
    assert dense.shape == (3, 512 if n == 3 else 256)

    meta = np.stack([tj.n_used, raw_lens.astype(np.int32)], axis=1).astype(np.int32)
    syms_t = jnp.transpose(data.reshape(3, LANES, C), (0, 2, 1))
    words, nbd = _encode_pallas_compact(
        syms_t, jnp.asarray(jhb.dense_rows(tj)), jnp.asarray(meta), arity=n,
        chunk_syms=C, interpret=True,
    )
    j_digits = np.transpose(np.asarray(nbd), (0, 2, 1)).reshape(3, LANES)
    j_bytes = np.asarray(words).reshape(3, -1).view(np.uint8)
    rows, digits, bb = kenc.encode_blocks(_t(data), _t(raw_lens, np.int32), dense, C, n)
    np.testing.assert_array_equal(digits.numpy(), j_digits)
    np.testing.assert_array_equal(bb.numpy(), wire_bytes(j_digits, n).sum(axis=1))
    assert rows.shape == (3, LANES * max_chunk_bytes(C, n))
    for b in range(2):
        k = int(bb[b])
        assert rows[b, :k].numpy().tobytes() == j_bytes[b, :k].tobytes(), f"block {b}"
    deep = b"".join(_chunks(data[2:], raw_lens[2:], jhb.codes_batch(tj.lengths[2:], n), C)[0])
    assert rows[2, : int(bb[2])].numpy().tobytes() == deep

    j_rows, j_nbytes, j_dig = encode_blocks_pallas(
        data, raw_lens, [tj.table(b) for b in range(3)], n, interpret=True
    )
    rows, digits = kenc.encode_chunk_rows(_t(data), _t(raw_lens, np.int32), dense, C, n)
    digits = digits.numpy()
    np.testing.assert_array_equal(digits, np.asarray(j_dig))
    nbytes = wire_bytes(digits, n)
    np.testing.assert_array_equal(nbytes, np.asarray(j_nbytes))
    assert digits[2 * LANES] == ARITY_MAX_LEN[n] * C
    assert nbytes[2 * LANES] == max_chunk_bytes(C, n), "the deep chunk must fill its row"
    j_rows = np.asarray(j_rows)
    for r in range(3 * LANES):
        assert rows[r, : nbytes[r]].numpy().tobytes() == j_rows[r, : nbytes[r]].tobytes()


@pytest.mark.parametrize("n", ARITIES)
@pytest.mark.parametrize("S,C", [(4096, 16), (8192, 1024)])
def test_encode_ref_matches_host_encoder(n, S, C):
    """Compact and per-chunk rows equal the JAX host encoder's chunks,
    including a partial last chunk, empty chunks and L-digit codes."""
    data, raw_lens, tj, tp = _blocks(n, S, C, 90 + n)
    dense = phb.encode_tensors(tp, "cpu")["dense"]
    rows, digits, bb = kenc.encode_blocks_ref(_t(data), _t(raw_lens, np.int32), dense, C, n)
    crow, cdig = kenc.encode_chunk_rows_ref(_t(data), _t(raw_lens, np.int32), dense, C, n)
    ncb = S // C
    np.testing.assert_array_equal(cdig.numpy().reshape(3, ncb), digits.numpy())
    for b in range(3):
        want = b""
        for c in range(ncb):
            cnt = max(0, min(C, int(raw_lens[b]) - c * C))
            chunk = jax_encode_chunk(data[b, c * C : c * C + cnt], tj.table(b))
            assert wire_bytes(digits[b, c], n) == len(chunk)
            assert crow[b * ncb + c, : len(chunk)].numpy().tobytes() == chunk
            want += chunk
        assert int(bb[b]) == len(want)
        assert rows[b, : len(want)].numpy().tobytes() == want, f"block {b}"


@pytest.mark.parametrize("n", ARITIES)
def test_decode_ref_matches_pallas_decode_kernel(n):
    """C=128: a complete tree (n=3: last limit exactly 3^15, beyond
    int32's field-packed range) and a chunk of L-digit codes."""
    from data_compression_tpu.ops.pallas.decode_kernel import LANES, decode_blocks_pallas

    C = 128
    data, raw_lens, tj, tp = _blocks(n, C * LANES, C, 100 + n)
    assert int(phb.decode_rows(tp, ARITY_MAX_LEN[n])["limit_scaled"][2, -1]) == n ** ARITY_MAX_LEN[n]
    chunks = _chunks(data, raw_lens, tj, C)
    want = decode_blocks_pallas(
        chunks, raw_lens, [tj.table(b) for b in range(3)], interpret=True, chunk_syms=C, arity=n,
    )
    got = _port_decode(tp, chunks, raw_lens, C, n)
    for b in range(3):
        assert got[b] == want[b] == data[b, : raw_lens[b]].tobytes(), f"block {b}"


@pytest.mark.parametrize("n", ARITIES)
@pytest.mark.parametrize("case", ["single_symbol", "empty_chunk", "tiny_chunks"])
def test_decode_ref_inverts_host_encoder(n, case):
    C = 512
    if case == "single_symbol":
        data = np.full((2, 1024), 97, np.uint8)
        raw_lens = [1024, 600]
    elif case == "empty_chunk":
        data = np.frombuffer(enwik_like(2048, 4), np.uint8).reshape(2, 1024).copy()
        raw_lens = [1024, 0]
    else:
        C = 16
        data = np.frombuffer(enwik_like(512, 5), np.uint8).reshape(2, 256).copy()
        raw_lens = [256, 37]
    hists = np.stack([np.bincount(data[b, :r], minlength=256) for b, r in enumerate(raw_lens)])
    tj = jhb.codes_batch(jhb.capped_lengths_batch(hists.astype(np.int64), n), n)
    tp = phb.TableBatch.from_arrays(dataclasses.asdict(tj))
    got = _port_decode(tp, _chunks(data, raw_lens, tj, C), raw_lens, C, n)
    for b, r in enumerate(raw_lens):
        assert got[b] == data[b, :r].tobytes(), f"block {b}"


@pytest.mark.parametrize("n", ARITIES)
def test_decode_ref_corrupt_stream_stays_in_bounds(n):
    """Random payload bytes (at n=3 including bytes 243..255, which the
    encoder never writes) decode to (wrong) bytes without raising."""
    rng = np.random.default_rng(3)
    data, raw_lens, tj, tp = _blocks(n, 4096, 512, 110 + n)
    chunks = [[bytes(rng.integers(0, 256, len(c), dtype=np.uint8)) for c in blk]
              for blk in _chunks(data, raw_lens, tj, 512)]
    if n == 3:
        assert any(max(c, default=0) >= 243 for blk in chunks for c in blk)
    got = _port_decode(tp, chunks, raw_lens, 512, n)
    assert [len(g) for g in got] == list(raw_lens)


def test_wrappers_check_arity_and_table_widths():
    data = torch.zeros((1, 256), dtype=torch.uint8)
    lens = torch.tensor([256], dtype=torch.int32)
    dense3 = torch.zeros((1, 512), dtype=torch.int32)
    dense3[0, 0], dense3[0, 256] = 2, 2  # symbol 0: one trit, 2
    rows, digits, bb = kenc.encode_blocks(data, lens, dense3, 128, 3)
    assert digits.tolist() == [[128, 128]] and bb.tolist() == [52]
    assert rows[0, :26].tolist() == [242] * 25 + [26]  # 2+6+18+54+162, then 3 trits
    with pytest.raises(ValueError):
        kenc.encode_blocks(data, lens, dense3[:, :256], 128, 3)
    with pytest.raises(ValueError):
        kenc.encode_chunk_rows(data, lens, dense3, 128, 16)
    with pytest.raises(ValueError):
        kenc.encode_blocks(data, lens, dense3[:, :256], 128, 4)  # no kernel for n=4
    z8 = torch.zeros((1, 8), dtype=torch.int32)
    args = dict(flat=torch.zeros(0, dtype=torch.uint8),
                chunk_off=torch.zeros(2, dtype=torch.int64),
                chunk_cnt=torch.tensor([5], dtype=torch.int32),
                chunk_blk=torch.zeros(1, dtype=torch.int32),
                limit=z8, bmf=z8, symbols=torch.zeros((1, 256), dtype=torch.int32),
                chunk_syms=16)
    before = kdec.decode_chunks.launches
    assert kdec.decode_chunks(**args, arity=16).shape == (1, 16)
    assert kdec.decode_chunks.launches == before
    with pytest.raises(ValueError):
        kdec.decode_chunks(**args, arity=3)  # n=3 tables are [B, 16]
    with pytest.raises(ValueError):
        kdec.decode_chunks(**args, arity=9)


# ----------------------------------------------------------------- slice

KB64 = 64 * 1024


def _case(name):
    rng = np.random.default_rng(53)
    return {
        "empty": lambda: b"",
        "one_byte": lambda: b"x",
        "block_plus_1": lambda: enwik_like(KB64 + 1, 42),
        "partial_last_chunk": lambda: enwik_like(KB64 + 3 * 512 + 100, 43),
        "single_symbol": lambda: b"a" * 100_000,
        "deep_codes": lambda: deep_code_block(KB64, 44) + enwik_like(5000, 45),
        "random_bytes": lambda: bytes(rng.integers(0, 256, 70_000, dtype=np.uint8)),
    }[name]()


CASES = [
    ("empty", {}),
    ("one_byte", {}),
    ("block_plus_1", {}),
    ("partial_last_chunk", {}),
    ("single_symbol", {}),
    ("deep_codes", {}),
    ("random_bytes", {}),
    ("block_plus_1", {"shared_table": True}),
    ("deep_codes", {"shared_table": True}),
    ("partial_last_chunk", {"block_size": 16384, "chunk_syms": 128}),
    ("block_plus_1", {"block_size": 4096, "chunk_syms": 16}),
]
IDS = [f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items()) or 'default'}" for n, kw in CASES]


@pytest.mark.parametrize("n", ARITIES)
@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_compress_byte_identical_and_cross_decode(n, name, kw):
    x = _case(name)
    frame = pt.compress(x, pt.CodecConfig(arity=n, **kw), device="cpu")
    assert frame == jx.compress(x, jx.CodecConfig(arity=n, use_device=False, **kw))
    assert pt.decompress(frame, device="cpu") == x
    assert jx.decompress(frame, jx.CodecConfig(use_device=False)) == x


@pytest.mark.parametrize("n", ARITIES)
def test_cross_decode_with_jax_device_path(n):
    """The JAX package's XLA device path (on the CPU) and the port give
    the same frame, and each decodes the other's."""
    x = enwik_like(3 * 4096 + 99, 48 + n)
    jcfg = jx.CodecConfig(arity=n, block_size=4096, chunk_syms=512, use_pallas=False)
    jframe = jx.compress(x, jcfg)
    assert pt.decompress(jframe, device="cpu") == x
    pframe = pt.compress(x, pt.CodecConfig(arity=n, block_size=4096, chunk_syms=512), device="cpu")
    assert pframe == jframe
    assert jx.decompress(pframe, jcfg) == x


def _payload_region(stream):
    f = framing.unpack_frame(stream)
    return len(stream) - sum(e.comp_len for e in f.entries), len(stream)


def _decode_outcome(decode, stream):
    try:
        return decode(stream)
    except ValueError:
        return ValueError


@pytest.mark.parametrize("n", ARITIES + GENERIC)
@pytest.mark.parametrize("shared", [False, True])
def test_corrupt_payload_bytes_raise_value_error(n, shared):
    """Seeded payload byte flips: each raises ValueError (parse, table or
    CRC) in the port exactly where it does in the JAX package; a flip
    that only touches the padding digits of a chunk's last byte (n = 3
    and the generic arities pack fewer than 8 bits' worth of digits)
    decodes to the original bytes in both."""
    x = enwik_like(2 * 1024 + 777, 60 + n + shared)
    cfg = pt.CodecConfig(arity=n, block_size=1024, chunk_syms=256, shared_table=shared)
    stream = pt.compress(x, cfg, device="cpu")
    lo, hi = _payload_region(stream)
    rng = np.random.default_rng(1300 + n + shared)
    positions = sorted(set(int(p) for p in rng.integers(lo, hi, 8))) + [lo, lo + 1, hi - 1]
    raised = 0
    for pos in positions:
        corrupt = bytearray(stream)
        corrupt[pos] ^= 0xFF
        got = _decode_outcome(lambda f: pt.decompress(f, device="cpu"), bytes(corrupt))
        want = _decode_outcome(lambda f: jx.decompress(f, jx.CodecConfig(use_device=False)),
                               bytes(corrupt))
        assert got == want, f"position {pos}"
        assert got is ValueError or got == x
        raised += got is ValueError
    assert raised >= len(positions) - 2


def test_n3_bytes_past_242_raise_value_error():
    """A chunk byte 243..255 (no 5-trit value) fails the CRC."""
    x = enwik_like(4096, 61)
    stream = pt.compress(x, pt.CodecConfig(arity=3, block_size=4096, chunk_syms=512), device="cpu")
    f = framing.unpack_frame(stream)
    _, chunks = phuff._unpack_payload(f.payloads[0])
    first = len(stream) - f.entries[0].comp_len + 1 + 256 + 2 + 2 * len(chunks)
    for b in (243, 250, 255):
        corrupt = bytearray(stream)
        corrupt[first + 3] = b
        with pytest.raises(ValueError):
            pt.decompress(bytes(corrupt), device="cpu")


# ----------------------------------------------------------- sharded path


@pytest.fixture
def gloo1(tmp_path):
    """A gloo world of one rank, destroyed after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    yield make_mesh("cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("n,shared", [(3, True), (16, False)])
def test_sharded_world1_equals_compress(gloo1, n, shared):
    x = enwik_like(96 * 1024 + 333, 70 + n)
    kw = dict(arity=n, block_size=8192, chunk_syms=1024, shared_table=shared)
    frame = compress_sharded(x, pt.CodecConfig(**kw), gloo1)
    assert frame == pt.compress(x, pt.CodecConfig(**kw), device="cpu")
    assert frame == jx.compress(x, jx.CodecConfig(use_device=False, **kw))
    assert decompress_sharded(frame, None, gloo1) == x


def test_sharded_generic_arity_as_jax(gloo1):
    """As the JAX package's: compress_sharded raises KeyError at an arity
    without a bit-field packing; decompress_sharded decodes its frames."""
    x = enwik_like(5000, 74)
    cfg = dict(arity=9, block_size=2048, chunk_syms=512)
    with pytest.raises(KeyError):
        jpipe.compress_sharded(x, jx.CodecConfig(**cfg), jmesh.make_mesh(shape=(8, 1)))
    with pytest.raises(KeyError):
        compress_sharded(x, pt.CodecConfig(**cfg), gloo1)
    frame = pt.compress(x, pt.CodecConfig(**cfg), device="cpu")
    assert decompress_sharded(frame, None, gloo1) == x
    assert compress_sharded(b"", pt.CodecConfig(**cfg), gloo1) == jpipe.compress_sharded(
        b"", jx.CodecConfig(**cfg), jmesh.make_mesh(shape=(8, 1)))


# ------------------------------------------------------- generic arities


@pytest.mark.parametrize("n", GENERIC)
@pytest.mark.parametrize("kw", [{}, {"shared_table": True}, {"block_size": 2048, "chunk_syms": 256}],
                         ids=["default", "shared", "2k-256"])
def test_generic_arity_host_path_equals_jax(n, kw):
    x = enwik_like(6000, 80 + n) + b"\x00\xff" * 50
    frame = pt.compress(x, pt.CodecConfig(arity=n, **kw), device="cpu")
    assert frame == jx.compress(x, jx.CodecConfig(arity=n, use_device=False, **kw))
    assert pt.decompress(frame, device="cpu") == x
    assert jx.decompress(frame, jx.CodecConfig(use_device=False)) == x
    jframe = jx.compress(x, jx.CodecConfig(arity=n, **kw))  # the JAX device histogram
    assert pt.decompress(jframe, device="cpu") == x


def test_cli_arities(tmp_path, capsys):
    x = enwik_like(20_000, 90)
    src, dst, back = tmp_path / "in", tmp_path / "out.dctz", tmp_path / "back"
    src.write_bytes(x)
    for n in (16, 3, 9):
        assert pcli.main(["compress", "-n", str(n), "--block-size", "8192", "--device", "cpu",
                          str(src), str(dst)]) == 0
        assert dst.read_bytes() == jx.compress(
            x, jx.CodecConfig(arity=n, block_size=8192, use_device=False))
        assert pcli.main(["decompress", "--device", "cpu", str(dst), str(back)]) == 0
        assert back.read_bytes() == x
        assert pcli.main(["info", str(dst)]) == 0
        assert f'"arity": {n}' in capsys.readouterr().out
