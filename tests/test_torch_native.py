"""The port's native C runtime (``data_compression_tpu_torch/native``)
against the JAX package's binding, the port's plain versions and zlib;
mirrors ``tests/test_native.py``.  Builds the port's ``libdctpu`` with
``cc`` here, on the CPU.  Tolerance: exact (bytes and integer arrays).
"""

import re
import zlib
from pathlib import Path

import numpy as np
import pytest

import data_compression_tpu.huffman.batched as jhb
from data_compression_tpu_torch import native
from data_compression_tpu_torch.config import ARITY_MAX_LEN
from data_compression_tpu_torch.huffman import batched as phb
from data_compression_tpu_torch.models import nybble, small
from data_compression_tpu_torch.models.huffman import decode_chunk_np, encode_chunk_np
from tests.conftest import ascii_text
from tests.test_torch_host import HIST_KINDS, _hists

ROOT = Path(__file__).resolve().parents[1]
ARITIES = [2, 3, 4, 7, 16, 64]


def _from_first_include(path: Path) -> str:
    text = path.read_text()
    return text[text.index("\n#include") + 1:]


def test_source_is_the_originals():
    """The port's libdctpu.c is the JAX package's, from the first
    #include to the end; only the header comment differs."""
    port = ROOT / "data_compression_tpu_torch" / "native" / "libdctpu.c"
    orig = ROOT / "data_compression_tpu" / "native" / "libdctpu.c"
    assert _from_first_include(port) == _from_first_include(orig)
    assert port.read_text().startswith("/* libdctpu — native CPU runtime of data_compression_tpu_torch.")


def test_library_builds_under_the_port_build_dir():
    lib = native.load()
    assert native.load() is lib
    assert native.openmp in (True, False)
    built = list(native.BUILD_DIR.glob("libdctpu-*.so"))
    assert built and all(re.fullmatch(r"libdctpu-[0-9a-f]{16}-(omp|serial)\.so", p.name)
                         for p in built)


@pytest.mark.parametrize("n", ARITIES)
@pytest.mark.parametrize("kind", HIST_KINDS)
def test_capped_lengths_match_plain_and_jax(kind, n):
    h = _hists(kind)
    got = native.huffman_capped_lengths_batch(h, n, ARITY_MAX_LEN[n])
    assert got.dtype == np.int32 and got.shape == h.shape
    np.testing.assert_array_equal(got, phb.capped_lengths_batch_ref(h, n))
    np.testing.assert_array_equal(got, jhb.capped_lengths_batch(h, n))
    np.testing.assert_array_equal(phb.capped_lengths_batch(h, n), got)
    if kind == "fib_deep" and n == 2:
        assert got.max() == 15, "fixture lost its depth"


@pytest.mark.parametrize("n", [2, 3, 4, 7, 16])
def test_complete_tree_at_the_cap(n):
    """Frequencies n**level, n - 1 symbols a level, plus one symbol of
    frequency 1: the halving rescale ends in a complete tree (Kraft sum
    exactly 1) at the length cap."""
    L = ARITY_MAX_LEN[n]
    levels = min(255 // (n - 1), int(62 / np.log2(n)))
    f = np.zeros((1, 256), np.int64)
    f[0, 0] = 1
    f[0, 1:1 + (n - 1) * levels] = np.repeat(np.int64(n) ** np.arange(levels, dtype=np.int64),
                                             n - 1)
    got = native.huffman_capped_lengths_batch(f, n, L)
    np.testing.assert_array_equal(got, phb.capped_lengths_batch_ref(f, n))
    np.testing.assert_array_equal(got, jhb.capped_lengths_batch(f, n))
    assert got.max() == L
    assert sum(n ** (L - int(x)) for x in got[got > 0]) == n ** L


def test_capped_lengths_rejects_bad_input():
    with pytest.raises(ValueError):
        native.huffman_capped_lengths_batch(np.ones((1, 300), np.int64), 2, 15)
    with pytest.raises(ValueError, match="native huffman lengths error"):
        native.huffman_capped_lengths_batch(np.ones((2, 256), np.int64), 65, 15)
    # alphabets above 256 symbols take the plain version
    h = np.random.default_rng(8).integers(0, 50, (2, 300)).astype(np.int64)
    np.testing.assert_array_equal(phb.capped_lengths_batch(h, 3),
                                  phb.capped_lengths_batch_ref(h, 3))


def test_crc32_matches_zlib(rng):
    for size in [0, 1, 3, 100, 4097]:
        data = bytes(rng.integers(0, 256, size=size, dtype=np.uint8))
        assert native.crc32(data) == zlib.crc32(data)
        assert native.crc32(data, 12345) == zlib.crc32(data, 12345)


CODECS = {
    # kind: (host encoder, host decoder, input alphabet)
    "nybble": (nybble.encode_host, nybble.decode_host, "ascii"),
    "small_byte": (small.small_byte_encode_host, small.small_byte_decode_host, "ascii"),
    "small_nybble": (small.small_nybble_encode_host, small.small_nybble_decode_host, "bytes"),
}


def _blocks(kind, rng, sizes, S):
    rows = np.zeros((len(sizes), S), np.uint8)
    for i, n in enumerate(sizes):
        if CODECS[kind][2] == "ascii":
            rows[i, :n] = np.frombuffer(ascii_text(rng, n), np.uint8) if n else []
        else:
            rows[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    return rows, np.asarray(sizes, np.int64)


@pytest.mark.parametrize("kind", sorted(CODECS))
def test_batch_drivers_match_host_codecs(kind, rng):
    """encode_batch / decode_batch against the port's host encoders and
    decoders, block by block: empty, one byte, partial and full blocks;
    4000 bytes wrap the LZW slots."""
    enc, dec, _ = CODECS[kind]
    S = 4096
    blocks, lens = _blocks(kind, rng, [0, 1, 2, 300, 4000, S], S)
    payloads = native.encode_batch(kind, blocks, lens)
    assert payloads == [enc(blocks[i, :n].tobytes()) for i, n in enumerate(lens)]
    back = native.decode_batch(kind, payloads, lens)
    assert back == [blocks[i, :n].tobytes() for i, n in enumerate(lens)]
    assert back == [dec(p, int(n)) for p, n in zip(payloads, lens)]
    one = getattr(native, f"{kind}_encode")(blocks[4, :4000].tobytes())
    assert one == payloads[4]
    assert getattr(native, f"{kind}_decode")(one, 4000) == blocks[4, :4000].tobytes()
    assert native.encode_batch(kind, blocks[:0], lens[:0]) == []
    assert native.decode_batch(kind, [], []) == []


@pytest.mark.parametrize("kind", sorted(CODECS))
def test_batch_drivers_raise_value_error(kind, rng):
    """Corrupt payloads raise ValueError naming the block, never crash;
    malformed sizes are refused before any pointer reaches C."""
    enc, _, _ = CODECS[kind]
    blocks, lens = _blocks(kind, rng, [2000, 2000], 2048)
    payloads = native.encode_batch(kind, blocks, lens)
    with pytest.raises(ValueError, match="block 1"):
        native.decode_batch(kind, [payloads[0], payloads[1][:5]], lens)
    with pytest.raises(ValueError, match="decode error"):
        native.decode_batch(kind, [b"\x00"], [10])
    for _ in range(50):
        corrupt = bytearray(payloads[0])
        for _ in range(int(rng.integers(1, 4))):
            corrupt[int(rng.integers(0, len(corrupt)))] ^= int(rng.integers(1, 256))
        try:
            native.decode_batch(kind, [bytes(corrupt)], [2000])
        except ValueError:
            pass
    with pytest.raises(ValueError):
        native.encode_batch(kind, blocks, [3000, 10])
    with pytest.raises(ValueError):
        native.decode_batch(kind, payloads, [-1, 10])
    with pytest.raises(ValueError):
        native.encode_batch("huffman", blocks, lens)


def test_nybble_and_small_byte_refuse_8bit_input():
    data = bytes([0x41, 0x90, 0x42])
    for kind in ("nybble", "small_byte"):
        with pytest.raises(ValueError, match="encode error"):
            getattr(native, f"{kind}_encode")(data)


@pytest.mark.parametrize("arity", [2, 3, 16])
def test_huffman_chunk_roundtrip(arity, rng):
    """huffman_encode_chunk / huffman_decode_chunk (bound for parity
    only, on no path of the port) against encode_chunk_np /
    decode_chunk_np, with the port's table rows."""
    data = np.frombuffer(ascii_text(rng, 2048), np.uint8)
    hist = np.bincount(data, minlength=256)[None, :].astype(np.int64)
    tb = phb.codes_batch(phb.capped_lengths_batch(hist, arity), arity)
    table = tb.table(0)
    pt, bt = phb.packed_rows(tb)
    payload = native.huffman_encode_chunk(data, pt[0], bt[0], arity)
    assert payload == encode_chunk_np(data, table)
    L = ARITY_MAX_LEN[arity]
    rows = phb.decode_rows(tb, L)
    dec = {k: v[0] for k, v in rows.items()}
    got = native.huffman_decode_chunk(payload, len(data), dec, arity, L)
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, decode_chunk_np(payload, len(data), table))
    with pytest.raises(ValueError):
        native.huffman_encode_chunk(data, pt[0], bt[0], 4)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """No compiler: load() raises RuntimeError with the reason (after the
    serial retry), never returns None."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(RuntimeError, match="no-such-cc") as e:
        native.load()
    assert str(e.value).count("no-such-cc") >= 2  # OpenMP build, then the serial one
    with pytest.raises(RuntimeError):
        phb.capped_lengths_batch(np.ones((1, 256), np.int64), 2)


def test_serial_retry_without_openmp(monkeypatch, tmp_path):
    """When the OpenMP build fails, the serial build loads and
    ``openmp`` says so."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "openmp", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "OPENMP_FLAG", "-fno-such-flag")
    lib = native.load()
    assert native.openmp is False and lib is native._lib
    assert [p.name.endswith("-serial.so") for p in (tmp_path / "build").iterdir()] == [True]
    h = _hists("enwik")
    np.testing.assert_array_equal(native.huffman_capped_lengths_batch(h, 3, 15),
                                  phb.capped_lengths_batch_ref(h, 3))
