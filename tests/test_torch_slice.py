"""The slice end to end on the CPU: ``data_compression_tpu_torch``'s
``compress`` must give the same container bytes as
``data_compression_tpu.compress`` (host path), each package must decode
the other's frames, and corrupt frames must raise ValueError.

Tolerance: exact — frames and decoded outputs are compared as bytes.
"""

import dataclasses
import io

import numpy as np
import pytest

import data_compression_tpu as jx
from data_compression_tpu import api as japi
import data_compression_tpu_torch as pt
from data_compression_tpu_torch import cli as pcli
from data_compression_tpu_torch.utils.corpora import deep_code_block, enwik_like

KB64 = 64 * 1024


def _case(name):
    rng = np.random.default_rng(52)
    return {
        "empty": lambda: b"",
        "one_byte": lambda: b"x",
        "block_minus_1": lambda: enwik_like(KB64 - 1, 41),
        "block_plus_1": lambda: enwik_like(KB64 + 1, 42),
        "partial_last_chunk": lambda: enwik_like(KB64 + 3 * 512 + 100, 43),
        "single_symbol": lambda: b"a" * 100_000,
        "deep_codes": lambda: deep_code_block(KB64, 44) + enwik_like(5000, 45),
        "random_bytes": lambda: bytes(rng.integers(0, 256, 70_000, dtype=np.uint8)),
        "enwik_mib": lambda: enwik_like(1 << 20, 46),
    }[name]()


CASES = [
    # (input, port config kwargs)
    ("empty", {}),
    ("one_byte", {}),
    ("block_minus_1", {}),
    ("block_plus_1", {}),
    ("partial_last_chunk", {}),
    ("single_symbol", {}),
    ("deep_codes", {}),
    ("random_bytes", {}),
    ("enwik_mib", {}),
    ("block_plus_1", {"shared_table": True}),
    ("deep_codes", {"shared_table": True}),
    ("partial_last_chunk", {"block_size": 16384, "chunk_syms": 128}),
    ("block_minus_1", {"block_size": 4096, "chunk_syms": 16}),
]
IDS = [f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items()) or 'default'}" for n, kw in CASES]


def _jax_frame(x, kw, meta=None):
    return jx.compress(x, jx.CodecConfig(use_device=False, **kw), meta=meta)


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_compress_byte_identical_and_cross_decode(name, kw):
    x = _case(name)
    frame = pt.compress(x, pt.CodecConfig(**kw), device="cpu")
    assert frame == _jax_frame(x, kw)
    assert pt.decompress(frame, device="cpu") == x  # port decodes its own
    assert jx.decompress(frame, jx.CodecConfig(use_device=False)) == x  # JAX decodes the port's


def test_literal_fallback_and_meta_block():
    x = _case("random_bytes")[:KB64] + enwik_like(KB64, 47)
    frame = pt.compress(x, meta=b"annotation bytes", device="cpu")
    assert frame == _jax_frame(x, {}, meta=b"annotation bytes")
    f = pt.framing.unpack_frame(frame)
    assert [e.is_meta for e in f.entries] == [True, False, False]
    assert [e.is_literal for e in f.entries] == [False, True, False]
    assert pt.decompress(frame, device="cpu") == x


def test_port_decodes_jax_device_path_frames():
    """Cross-decode of the JAX package's device path (XLA on the CPU),
    and the JAX device decoder on the port's frame."""
    x = enwik_like(3 * 4096 + 99, 48)
    jcfg = jx.CodecConfig(block_size=4096, chunk_syms=512, use_pallas=False)
    jframe = jx.compress(x, jcfg)
    assert pt.decompress(jframe, device="cpu") == x
    pframe = pt.compress(x, pt.CodecConfig(block_size=4096, chunk_syms=512), device="cpu")
    assert pframe == jframe
    assert jx.decompress(pframe, jcfg) == x


def _payload_region(stream):
    f = pt.framing.unpack_frame(stream)
    return len(stream) - sum(e.comp_len for e in f.entries), len(stream)


@pytest.mark.parametrize("shared", [False, True])
def test_corrupt_payload_bytes_raise_value_error(shared):
    """Seeded payload byte flips (x ^ 0xFF, so at least one code bit
    changes) raise ValueError: a table or chunk-length fault in the
    parse, or a CRC mismatch after decode."""
    x = enwik_like(2 * 4096 + 777, 49 + shared)
    cfg = pt.CodecConfig(block_size=4096, chunk_syms=512, shared_table=shared)
    stream = pt.compress(x, cfg, device="cpu")
    lo, hi = _payload_region(stream)
    rng = np.random.default_rng(1234 + shared)
    positions = sorted(set(int(p) for p in rng.integers(lo, hi, 10))) + [lo, lo + 1, lo + 258, hi - 1]
    for pos in positions:
        corrupt = bytearray(stream)
        corrupt[pos] ^= 0xFF
        with pytest.raises(ValueError):
            pt.decompress(bytes(corrupt), device="cpu")


def test_truncated_and_oversized_chunks_raise_value_error():
    x = enwik_like(5000, 50)
    stream = pt.compress(x, device="cpu")
    for frac in (0.1, 0.5, 0.99):
        with pytest.raises(ValueError):
            pt.decompress(stream[: int(len(stream) * frac)], device="cpu")
    # one chunk claiming more bytes than any chunk can hold
    from data_compression_tpu_torch.models.huffman import HuffmanCodec

    codec = HuffmanCodec(pt.CodecConfig(), "cpu")
    payload = b"\x00" + bytes(256) + (1).to_bytes(2, "little") + (2000).to_bytes(2, "little") + bytes(2000)
    with pytest.raises(ValueError, match="too large"):
        codec.decode_blocks([payload], [100])


def test_not_ported_paths_raise_not_implemented():
    """Only the printable container is left unported; every codec of
    CODEC_IDS decodes (the JAX package's nybble frame, also at a block
    size above 4096 that 4096 does not divide), and an unknown codec name
    raises ValueError."""
    text = b"hello hello hello " * 500
    for block_size in (65536, 6144):
        nyb = jx.compress(text, jx.CodecConfig(codec="nybble", block_size=block_size,
                                               use_device=False))
        assert pt.decompress(nyb, device="cpu") == text
    printable = jx.compress(text, jx.CodecConfig(use_device=False), printable=True)
    with pytest.raises(NotImplementedError):
        pt.decompress(printable, device="cpu")
    with pytest.raises(ValueError):
        pt.CodecConfig(codec="bogus")
    with pytest.raises(ValueError, match="unknown codec"):
        pt.get_codec(dataclasses.replace(pt.CodecConfig(), codec="bogus"), "cpu")


def test_cli_whole_files(tmp_path, capsys):
    x = enwik_like(3 * KB64 + 5, 51)
    src, dst, back = tmp_path / "in", tmp_path / "out.dctz", tmp_path / "back"
    src.write_bytes(x)
    assert pcli.main(["compress", "--device", "cpu", str(src), str(dst)]) == 0
    assert dst.read_bytes() == _jax_frame(x, {})
    assert pcli.main(["decompress", "--device", "cpu", str(dst), str(back)]) == 0
    assert back.read_bytes() == x
    assert pcli.main(["roundtrip", "--device", "cpu", "--shared-table", str(src)]) == 0
    capsys.readouterr()
    assert pcli.main(["info", str(dst)]) == 0
    info = capsys.readouterr().out
    assert '"num_blocks": 4' in info and '"codec": "huffman"' in info
    # the JAX package's streamed container (one frame per batch)
    streamed = io.BytesIO()
    japi.compress_stream(io.BytesIO(x), streamed, jx.CodecConfig(use_device=False),
                         batch_blocks=2)
    src.write_bytes(streamed.getvalue())
    assert pcli.main(["decompress", "--device", "cpu", str(src), str(back)]) == 0
    assert back.read_bytes() == x
