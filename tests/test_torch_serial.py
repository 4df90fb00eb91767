"""The serial codecs end to end on the CPU: ``literal``, ``nybble``,
``small_byte`` (with and without the ISPRINT mode) and ``small_nybble``.

The port's frames must equal the JAX package's byte for byte (JAX at
``use_device=False``, which takes its native route), each package must
decode the other's frames, the host route (``stats``) must give the
native route's payloads and the JAX package's counters, and every
corrupt stream must raise ValueError.  Mirrors ``tests/test_nybble.py``,
``tests/test_small.py`` and ``tests/test_fuzz_corruption.py``.

Tolerance: exact — frames, payloads, outputs and counters compared with ==.
"""

import zlib

import numpy as np
import pytest
import torch

import data_compression_tpu as jx
import data_compression_tpu.models.nybble as jnyb
import data_compression_tpu.models.small as jsmall
from data_compression_tpu.utils.debug import CodecStats as JStats

import data_compression_tpu_torch as pt
from data_compression_tpu_torch import cli as pcli
from data_compression_tpu_torch import framing
from data_compression_tpu_torch.config import CODEC_IDS
from data_compression_tpu_torch.models import nybble as pnyb
from data_compression_tpu_torch.models import small as psmall
from data_compression_tpu_torch.utils.corpora import enwik_like, printable_like
from data_compression_tpu_torch.utils.debug import CodecStats as PStats
from tests.conftest import ascii_text

REF_TEXT = (
    b"Hello, world. "
    b"This is a test. "
    b"This is only a test. "
    b"Banana banana banana banana. "
)

CODECS = {
    # name: config kwargs of both packages
    "literal": {"codec": "literal"},
    "nybble": {"codec": "nybble"},
    "small_byte": {"codec": "small_byte"},
    "small_byte_isprint": {"codec": "small_byte", "isprint_literal": True},
    "small_nybble": {"codec": "small_nybble"},
}
STATS_CODECS = ["nybble", "small_byte", "small_byte_isprint", "small_nybble"]


def _input(name):
    rng = np.random.default_rng(70)
    return {
        "enwik_256k": lambda: enwik_like(256 * 1024, 71),
        "partial_tail": lambda: enwik_like(100_000, 72),
        "high_bytes": lambda: (enwik_like(8192, 73)
                               + bytes(rng.integers(0, 256, 8192, dtype=np.uint8))
                               + enwik_like(5000, 74)),
        "printable": lambda: printable_like(20_000, 75),
        "mixed": lambda: printable_like(8192, 76) + enwik_like(8192, 77) + printable_like(3000, 78),
        "empty": lambda: b"",
        "one_byte": lambda: b"x",
        "block_6144": lambda: enwik_like(20_000, 79),
    }[name]()


INPUTS = {
    # name: block size (the default, 64 KiB, or smaller to keep the
    # ISPRINT mode's Python host route quick)
    "enwik_256k": 65536,
    "partial_tail": 65536,
    "high_bytes": 8192,
    "printable": 8192,
    "mixed": 8192,
    "empty": 65536,
    "one_byte": 65536,
    "block_6144": 6144,
}


def _configs(codec, block_size):
    kw = dict(CODECS[codec], block_size=block_size)
    return pt.CodecConfig(**kw), jx.CodecConfig(use_device=False, **kw)


@pytest.mark.parametrize("inp", sorted(INPUTS))
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_frames_byte_identical_and_cross_decode(codec, inp):
    x = _input(inp)
    pcfg, jcfg = _configs(codec, INPUTS[inp])
    frame = pt.compress(x, pcfg, device="cpu")
    assert frame == jx.compress(x, jcfg)
    assert pt.decompress(frame, device="cpu") == x
    if INPUTS[inp] > 4096 and INPUTS[inp] % 4096:
        # the reference cannot decode its own serial frame at this block
        # size (it takes chunk_syms 4096); the port can
        with pytest.raises(ValueError, match="chunk_syms 4096 must divide"):
            jx.decompress(frame, jcfg)
    else:
        assert jx.decompress(frame, jcfg) == x


def test_isprint_mode_writes_both_block_types():
    """A mixed frame: all-printable blocks are 0x1f streams, the block
    with a newline a scheme-A (type 8) stream; bytes >= 0x80 fall back to
    LITERAL blocks."""
    x = printable_like(8192, 81) + enwik_like(8192, 82) + bytes([0x90]) * 8192 + printable_like(
        3000, 83)
    frame = pt.compress(x, pt.CodecConfig(codec="small_byte", block_size=8192,
                                          isprint_literal=True), device="cpu")
    f = framing.unpack_frame(frame)
    assert [e.is_literal for e in f.entries] == [False, False, True, False]
    assert [f.payloads[i][0] for i in (0, 1, 3)] == [0x1F, 0x08, 0x1F]
    assert pt.decompress(frame, device="cpu") == x


@pytest.mark.parametrize("codec", STATS_CODECS)
def test_host_route_matches_native_route_and_jax_counters(codec):
    """stats=CodecStats(...) routes encode through the Python host
    encoders: the same frame as the native route, and the same counters
    as the JAX package's."""
    x = _input("high_bytes")[:12_000] if codec != "small_byte_isprint" else _input("mixed")[:12_000]
    pcfg, jcfg = _configs(codec, 8192)
    nctx = 16 if codec == "nybble" else 32
    ps, js = PStats(nctx), JStats(nctx)
    frame = pt.compress(x, pcfg, device="cpu", stats=ps)
    assert frame == pt.compress(x, pcfg, device="cpu")
    assert frame == jx.compress(x, jcfg, stats=js)
    assert (ps.times_used_directly, ps.hits, ps.literals) == (
        js.times_used_directly, js.hits, js.literals)
    assert ps.hits > 0 and ps.literals > 0


@pytest.mark.parametrize("codec", ["huffman", "literal"])
def test_stats_refused_for_other_codecs(codec):
    with pytest.raises(ValueError, match="stats collection supports codecs"):
        pt.compress(b"abc", pt.CodecConfig(codec=codec), device="cpu", stats=PStats())


FUZZ = {
    # name: (config kwargs, input maker) as tests/test_fuzz_corruption.py
    # (ascii text, 1.5 blocks); ISPRINT on printable text
    "literal": ({"codec": "literal", "block_size": 8192}, ascii_text),
    "nybble": ({"codec": "nybble", "block_size": 8192}, ascii_text),
    "small_byte": ({"codec": "small_byte", "block_size": 8192}, ascii_text),
    "small_byte_isprint": ({"codec": "small_byte", "block_size": 8192, "isprint_literal": True},
                           lambda rng, n: printable_like(n, int(rng.integers(1 << 30)))),
    "small_nybble": ({"codec": "small_nybble", "block_size": 4096}, ascii_text),
}


def _payload_region(stream):
    f = framing.unpack_frame(stream)
    return len(stream) - sum(e.comp_len for e in f.entries), len(stream)


@pytest.mark.parametrize("name", sorted(FUZZ))
def test_bitflip_fuzz(name):
    kw, make = FUZZ[name]
    cfg = pt.CodecConfig(**kw)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    data = make(rng, 3 * cfg.block_size // 2)
    stream = pt.compress(data, cfg, device="cpu")
    lo, hi = _payload_region(stream)
    assert hi > lo
    for _ in range(40):
        corrupt = bytearray(stream)
        for _ in range(int(rng.integers(1, 4))):
            corrupt[int(rng.integers(lo, hi))] ^= 1 << int(rng.integers(0, 8))
        with pytest.raises(ValueError):
            pt.decompress(bytes(corrupt), device="cpu")
    for pos in (lo, lo + 1, hi - 1):  # type byte, first byte, last byte
        corrupt = bytearray(stream)
        corrupt[pos] ^= 0xFF
        with pytest.raises(ValueError):
            pt.decompress(bytes(corrupt), device="cpu")


@pytest.mark.parametrize("name", sorted(FUZZ))
def test_truncation_fuzz(name):
    kw, make = FUZZ[name]
    cfg = pt.CodecConfig(**kw)
    rng = np.random.default_rng(1 + zlib.crc32(name.encode()))
    stream = pt.compress(make(rng, cfg.block_size + 100), cfg, device="cpu")
    for frac in (0.25, 0.5, 0.9, 0.99):
        with pytest.raises(ValueError):
            pt.decompress(stream[: int(len(stream) * frac)], device="cpu")


def test_host_codecs_match_the_originals(rng):
    """The plain versions: host encoders and decoders equal the JAX
    package's (canned text, random ascii, slot wrap-around, the static
    nybble table)."""
    texts = [REF_TEXT, b"aaaa", ascii_text(rng, 3000),
             bytes(rng.integers(1, 127, size=6000, dtype=np.uint8))]
    for t in texts:
        for penc, jenc, pdec in ((pnyb.encode_host, jnyb.encode_host, pnyb.decode_host),
                                 (psmall.small_byte_encode_host, jsmall.small_byte_encode_host,
                                  psmall.small_byte_decode_host),
                                 (psmall.small_nybble_encode_host,
                                  jsmall.small_nybble_encode_host,
                                  psmall.small_nybble_decode_host)):
            comp = penc(t)
            assert comp == jenc(t)
            assert pdec(comp, len(t)) == t
    p = printable_like(3000, 80)
    comp = psmall.small_isprint_encode_host(p)
    assert comp == jsmall.small_isprint_encode_host(p)
    assert psmall.small_isprint_decode_host(comp, len(p)) == p
    assert pnyb.encode_host(REF_TEXT, modify=False) == jnyb.encode_host(REF_TEXT, modify=False)
    assert len(pnyb.encode_host(REF_TEXT)) <= 70  # nybble_compression.c:1178
    with pytest.raises(ValueError):
        pnyb.encode_host(b"a\x80b")
    with pytest.raises(ValueError):
        psmall.small_isprint_encode_host(b"a\nb")


@pytest.mark.parametrize("dec,type_byte", [
    (psmall.small_byte_decode_host, 0x08),
    (psmall.small_isprint_decode_host, 0x1F),
    (psmall.small_nybble_decode_host, 0x08),
])
def test_host_decoders_raise_value_error_on_short_streams(dec, type_byte):
    """A stream of its type byte alone, and scheme A's unused index 0xFF,
    raise ValueError (the originals raise IndexError there)."""
    with pytest.raises(ValueError):
        dec(bytes([type_byte]), 5)
    if dec is psmall.small_byte_decode_host:
        with pytest.raises(ValueError, match="word index"):
            dec(bytes([0x08, 0x41, 0xFF]), 5)


def test_every_codec_is_registered():
    """No codec of CODEC_IDS is left unported; names stay as the
    original's."""
    assert pt.available_codecs() == sorted(CODEC_IDS)
    for name in CODEC_IDS:
        codec = pt.get_codec(pt.CodecConfig(codec=name), "cpu")
        assert codec.name == name and codec.device == torch.device("cpu")


@pytest.mark.parametrize("codec", ["literal", "nybble", "small_byte", "small_nybble"])
def test_serial_codec_for_cuda_without_a_card_raises(codec, monkeypatch):
    """The serial codecs run on the host; one made for ``cuda`` where no
    CUDA device is present raises, on compress and decompress."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pt.CodecConfig(codec=codec)
    frame = pt.compress(REF_TEXT, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.compress(REF_TEXT, cfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.decompress(frame, device="cuda")


@pytest.mark.parametrize("codec", ["literal", "nybble", "small_byte", "small_nybble"])
def test_cli_serial_codecs(codec, tmp_path, capsys):
    x = _input("high_bytes")
    src, dst, back = tmp_path / "in", tmp_path / "out.dctz", tmp_path / "back"
    src.write_bytes(x)
    args = ["-c", codec, "--block-size", "8192", "--device", "cpu"]
    assert pcli.main(["compress", *args, str(src), str(dst)]) == 0
    assert dst.read_bytes() == jx.compress(x, jx.CodecConfig(codec=codec, block_size=8192,
                                                             use_device=False))
    assert pcli.main(["decompress", "--device", "cpu", str(dst), str(back)]) == 0
    assert back.read_bytes() == x
    capsys.readouterr()
    assert pcli.main(["roundtrip", *args, "--stats", str(src)]) == 0
    err = capsys.readouterr().err
    assert "OK: " in err
    if codec == "literal":
        assert "--stats supports codecs" in err and "stats:" not in err
    else:
        js = JStats(16 if codec == "nybble" else 32)
        jx.compress(x, jx.CodecConfig(codec=codec, block_size=8192, use_device=False), stats=js)
        assert f"stats: {js.summary()}" in err


def test_cli_isprint_literal_and_stats(tmp_path, capsys):
    x = _input("mixed")
    src, dst = tmp_path / "in", tmp_path / "out.dctz"
    src.write_bytes(x)
    assert pcli.main(["compress", "-c", "small_byte", "--isprint-literal", "--stats",
                      "--block-size", "8192", "--device", "cpu", str(src), str(dst)]) == 0
    js = JStats(32)
    want = jx.compress(x, jx.CodecConfig(codec="small_byte", block_size=8192,
                                         isprint_literal=True, use_device=False), stats=js)
    assert dst.read_bytes() == want
    assert f"stats: {js.summary()}" in capsys.readouterr().err
    assert pcli.main(["info", str(dst)]) == 0
    assert '"codec": "small_byte"' in capsys.readouterr().out
