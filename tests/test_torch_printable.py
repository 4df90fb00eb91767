"""The printable container and the armor alphabets: the port against the
JAX package on the CPU.

``utils/base64url.py`` must give the original's text and raise the
original's errors (its Z85 span codec is vectorised); printable frames
and streams must be byte-identical and each package must read the
other's; every truncation or flipped byte of a printable stream must
raise ValueError (or decode exactly, where the flip hit no information).
Mirrors ``tests/test_printable.py``, the armor cases of
``tests/test_utils.py`` and ``tests/test_fuzz_corruption.py``'s printable
cases.  Tolerance: exact — texts, frames and outputs compared as bytes.
"""

import io

import numpy as np
import pytest

import data_compression_tpu as jx
from data_compression_tpu import api as japi
from data_compression_tpu import framing as jframing
from data_compression_tpu.cli import main as jmain
from data_compression_tpu.utils import base64url as jb64
import data_compression_tpu_torch as pt
from data_compression_tpu_torch import api as papi
from data_compression_tpu_torch import framing as pframing
from data_compression_tpu_torch.cli import main as pmain
from data_compression_tpu_torch.utils import base64url as pb64
from tests.conftest import ascii_text

ALPHABETS = [("base64url", "armor", "dearmor"), ("z85", "z85_armor", "z85_dearmor"),
             ("ascii85", "ascii85_armor", "ascii85_dearmor")]


def _pair(codec, **kw):
    """The same format config in both packages."""
    return (jx.CodecConfig(codec=codec, use_device=False, **kw),
            pt.CodecConfig(codec=codec, **kw))


def _outcome(fn, *args):
    """('ok', result) or (exception type name, message)."""
    try:
        return "ok", fn(*args)
    except Exception as e:  # noqa: BLE001 - the comparison is of the exception
        return type(e).__name__, str(e)


# ---- armor --------------------------------------------------------------

@pytest.mark.parametrize("size", [0, 1, 2, 3, 100, 5000])
@pytest.mark.parametrize("alphabet,enc,dec", ALPHABETS, ids=[a[0] for a in ALPHABETS])
def test_armor_text_equals_jax(size, alphabet, enc, dec):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    text = getattr(pb64, enc)(data)
    assert text == getattr(jb64, enc)(data)
    assert all(ln.isascii() and ln.isprintable() for ln in text.splitlines())
    assert getattr(pb64, dec)(text) == getattr(jb64, dec)(text) == data


@pytest.mark.parametrize("size", [0, 1, 2, 3, 4, 5, 100, 5000])
def test_z85_core_equals_jax(size):
    data = np.random.default_rng(size + 7).integers(0, 256, size, dtype=np.uint8).tobytes()
    text = pb64.z85_core(data)
    assert text == jb64.z85_core(data) and len(text) == pb64.z85_core_len(size)
    assert pb64.z85_core_decode(text, size) == data


BAD_SPANS = [
    ("short", "%nSc0%nS", 8),
    ("long", "0000000000", 4),
    ("bad digit", "a~bcd", 4),
    ("quote", 'abcd"', 4),
    ("backslash", "abc\\d", 4),
    ("non-ascii", "abéde", 4),
    ("overflow", "#####", 4),
    ("overflow before a bad digit", "#####abc~e", 8),
    ("bad digit before an overflow", "abc~e#####", 8),
    ("bad digit in the last group", "0000000000000~0", 12),
]


@pytest.mark.parametrize("name,text,nbytes", BAD_SPANS, ids=[b[0] for b in BAD_SPANS])
def test_z85_core_decode_errors_equal_jax(name, text, nbytes):
    got = _outcome(pb64.z85_core_decode, text, nbytes)
    assert got[0] == "ValueError" and got == _outcome(jb64.z85_core_decode, text, nbytes)


@pytest.mark.parametrize("fn,text", [
    ("dearmor", "DC1:3\nA!A\n.\n"),
    ("dearmor", "XX:3\nAAAA\n.\n"),
    ("dearmor", "DC1:9\nAAAA\n.\n"),
    ("z85_dearmor", "DCZ:4\n0000\n~\n"),
    ("z85_dearmor", "DCZ:4\n0000~\n~\n"),
    ("z85_dearmor", "DCZ:4\n#####\n~\n"),
    ("ascii85_dearmor", "DCA:4\n!!z!!\n~\n"),
    ("ascii85_dearmor", "DCA:4\n!!v!!\n~\n"),
    ("ascii85_dearmor", "DCA:x\n!!!!!\n~\n"),
    ("ascii85_dearmor", "DCA:4\nuuuuu\n~\n"),
])
def test_dearmor_errors_equal_jax(fn, text):
    got = _outcome(getattr(pb64, fn), text)
    assert got[0] != "ok" and got == _outcome(getattr(jb64, fn), text)


def test_armor_cli_equals_jax(tmp_path):
    data = np.random.default_rng(3).integers(0, 256, 333, dtype=np.uint8).tobytes()
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    for alpha, *_ in ALPHABETS:
        a, aj, b = tmp_path / f"a.{alpha}", tmp_path / f"aj.{alpha}", tmp_path / f"b.{alpha}"
        assert pmain(["armor", "-a", alpha, str(src), str(a)]) == 0
        assert jmain(["armor", "-a", alpha, str(src), str(aj)]) == 0
        assert a.read_bytes() == aj.read_bytes()
        assert pmain(["dearmor", str(aj), str(b)]) == 0
        assert b.read_bytes() == data


# ---- the printable container -------------------------------------------

@pytest.mark.parametrize("codec,kw", [
    ("huffman", {}), ("huffman", {"arity": 16}), ("huffman", {"arity": 3}),
    ("huffman", {"shared_table": True}), ("nybble", {}), ("literal", {}),
])
def test_printable_frame_equals_jax(codec, kw):
    data = ascii_text(np.random.default_rng(1), 3 * 4096 + 123)
    jcfg, pcfg = _pair(codec, block_size=4096, chunk_syms=512, **kw)
    out = pt.compress(data, pcfg, device="cpu", printable=True)
    assert out == jx.compress(data, jcfg, printable=True)
    assert all(32 <= b < 127 or b == 10 for b in out)
    assert pt.decompress(out, device="cpu") == data == jx.decompress(out, jcfg)
    binary = pt.compress(data, pcfg, device="cpu")
    assert pframing.printable_to_frame(out) == binary == jframing.printable_to_frame(out)
    assert pframing.frame_to_printable(binary) == out


def test_read_frame_mixed_stream_equals_jax():
    """A printable frame, a binary frame, a printable shared-table frame:
    read_frame returns the same binary frames in both packages."""
    rng = np.random.default_rng(2)
    a, b, c = (ascii_text(rng, n) for n in (3000, 2000, 5000))
    jcfg, pcfg = _pair("huffman", block_size=1024, chunk_syms=512)
    jshared, pshared = _pair("huffman", block_size=1024, chunk_syms=512, shared_table=True)
    blob = (pt.compress(a, pcfg, device="cpu", printable=True)
            + pt.compress(b, pcfg, device="cpu")
            + pt.compress(c, pshared, device="cpu", printable=True))
    assert blob == (jx.compress(a, jcfg, printable=True) + jx.compress(b, jcfg)
                    + jx.compress(c, jshared, printable=True))
    js, ps = io.BytesIO(blob), io.BytesIO(blob)
    for _ in range(3):
        frame = pframing.read_frame(ps)
        assert frame is not None and frame == jframing.read_frame(js)
    assert pframing.read_frame(ps) is None and jframing.read_frame(js) is None


def test_printable_unknown_codec_id_raises_value_error():
    """The port's check of the codec id (after the header CRC) holds on
    the printable path: printable_to_frame and read_frame raise
    ValueError where the JAX package returns the frame."""
    import struct

    from data_compression_tpu_torch.utils.crc import crc32

    frame = bytearray(pt.compress(b"hello " * 100, device="cpu"))
    frame[8] = 99
    frame[28:32] = struct.pack("<I", crc32(bytes(frame[:28])))
    blob = jframing.frame_to_printable(bytes(frame))
    with pytest.raises(ValueError, match="codec id 99"):
        pframing.printable_to_frame(blob)
    with pytest.raises(ValueError, match="codec id 99"):
        pframing.read_frame(io.BytesIO(blob))
    with pytest.raises(ValueError, match="codec id 99"):
        pt.decompress(blob, device="cpu")


def _printable_stream(codec):
    """A streamed printable container of three frames, equal to the JAX
    package's; -> (input, stream, frame start offsets)."""
    data = ascii_text(np.random.default_rng(4), 5 * 1024)
    jcfg, pcfg = _pair(codec, block_size=1024, chunk_syms=512)
    buf = io.BytesIO()
    papi.compress_stream(io.BytesIO(data), buf, pcfg, batch_blocks=2, printable=True,
                         device="cpu")
    jbuf = io.BytesIO()
    japi.compress_stream(io.BytesIO(data), jbuf, jcfg, batch_blocks=2, printable=True)
    blob = buf.getvalue()
    assert blob == jbuf.getvalue()
    starts = [p for p in range(len(blob)) if blob.startswith(pframing.PRINTABLE_MAGIC, p)]
    assert len(starts) == 3 and starts[0] == 0
    back = io.BytesIO()
    assert papi.decompress_stream(io.BytesIO(blob), back, device="cpu")["frames"] == 3
    assert back.getvalue() == data
    return data, blob, starts


def _raises_or_exact(blob, data):
    """decompress_stream of ``blob`` raises ValueError or gives ``data``."""
    back = io.BytesIO()
    try:
        papi.decompress_stream(io.BytesIO(blob), back, device="cpu")
    except ValueError:
        return True
    return back.getvalue() == data


def test_printable_stream_every_truncation_raises():
    """Every cut of a literal-codec stream (the container's own parse and
    CRCs, cheap to decode), and every cut inside the first frame of a
    Huffman stream (nothing decodes before the read fails), raises
    ValueError; a cut at a frame boundary is a shorter valid stream."""
    for codec in ("literal", "huffman"):
        data, blob, starts = _printable_stream(codec)
        for cut in range(1, len(blob) if codec == "literal" else starts[1]):
            if cut in starts:
                continue
            with pytest.raises(ValueError):
                papi.decompress_stream(io.BytesIO(blob[:cut]), io.BytesIO(), device="cpu")


def test_printable_stream_every_flipped_byte_raises_or_decodes_exactly():
    """Every byte of a literal-codec stream flipped in one bit (the bit
    cycling with the position), and 24 seeded flips of a Huffman stream:
    ValueError, or the exact input where the flip only touched the
    padding of a span's last Z85 group."""
    data, blob, _ = _printable_stream("literal")
    for pos in range(len(blob)):
        corrupt = bytearray(blob)
        corrupt[pos] ^= 1 << (pos % 8)
        assert _raises_or_exact(bytes(corrupt), data), f"flip at {pos} escaped"
    data, blob, _ = _printable_stream("huffman")
    rng = np.random.default_rng(5)
    for _ in range(24):
        corrupt = bytearray(blob)
        pos = int(rng.integers(len(pframing.PRINTABLE_MAGIC), len(blob)))
        corrupt[pos] ^= 1 << int(rng.integers(0, 8))
        assert _raises_or_exact(bytes(corrupt), data), f"flip at {pos} escaped"
