"""The streaming and file drivers and the streamed CLI: the port against
the JAX package on the CPU.

The JAX CLI's ``compress`` writes one independent frame per
``--batch-blocks`` blocks read; the port's CLI must write the same bytes
(``compress --device cpu`` against ``compress --no-device``), its
``decompress`` / ``info`` must read frame by frame, and each package must
decode the other's multi-frame, printable and mixed streams.  Mirrors
``tests/test_streaming.py``.  Block size 4096 and batches of 2-4 blocks
keep several frames cheap.  Tolerance: exact — files compared as bytes.
"""

import io
import json

import numpy as np
import pytest

import data_compression_tpu as jx
from data_compression_tpu import api as japi
from data_compression_tpu.cli import main as jmain
import data_compression_tpu_torch as pt
from data_compression_tpu_torch import api as papi
from data_compression_tpu_torch.cli import main as pmain
from data_compression_tpu_torch.utils.corpora import enwik_like
from tests.conftest import ascii_text

BS = 4096


def _cli_pair(tmp_path, data, flags):
    """The JAX CLI's and the port's compress of ``data`` with ``flags``;
    -> (jax bytes, port bytes)."""
    src = tmp_path / "in"
    src.write_bytes(data)
    jout, pout = tmp_path / "jax.dctz", tmp_path / "port.dctz"
    assert jmain(["compress", "--no-device", *flags, str(src), str(jout)]) == 0
    assert pmain(["compress", "--device", "cpu", *flags, str(src), str(pout)]) == 0
    return jout.read_bytes(), pout.read_bytes()


CLI_CASES = [
    ("huffman_n2", ["--block-size", "4096", "--batch-blocks", "3"], 10 * BS + 77),
    ("huffman_n16", ["-n", "16", "--block-size", "4096", "--batch-blocks", "2"], 7 * BS + 5),
    ("huffman_n3", ["-n", "3", "--block-size", "4096", "--batch-blocks", "4"], 9 * BS),
    ("huffman_shared", ["--shared-table", "--block-size", "4096", "--batch-blocks", "2"],
     5 * BS + 1),
    ("small_byte", ["-c", "small_byte", "--block-size", "4096", "--batch-blocks", "2"],
     5 * BS + 300),
    ("printable", ["--printable", "--block-size", "4096", "--batch-blocks", "2"], 5 * BS + 9),
    ("printable_n16", ["--printable", "-n", "16", "--block-size", "4096", "--batch-blocks", "3"],
     7 * BS),
    ("one_batch", ["--block-size", "4096", "--batch-blocks", "4"], 4 * BS),
    ("empty", ["--block-size", "4096", "--batch-blocks", "2"], 0),
]


@pytest.mark.parametrize("name,flags,size", CLI_CASES, ids=[c[0] for c in CLI_CASES])
def test_cli_streamed_frames_equal_jax(tmp_path, name, flags, size):
    data = ascii_text(np.random.default_rng(size), size)
    want, got = _cli_pair(tmp_path, data, flags)
    assert got == want
    batch = int(flags[flags.index("--batch-blocks") + 1]) * BS
    frames = max(1, -(-size // batch))
    for decompress_stream in (lambda f, g: papi.decompress_stream(f, g, device="cpu"),
                              lambda f, g: japi.decompress_stream(
                                  f, g, jx.CodecConfig(use_device=False))):
        back = io.BytesIO()
        st = decompress_stream(io.BytesIO(got), back)
        assert st["frames"] == frames and back.getvalue() == data


def test_cli_literal_1_5_mb_writes_the_jax_frames(tmp_path):
    """The case where the whole-file CLI wrote one frame of 1,505,904
    bytes and the JAX CLI two frames of 1,505,936 bytes in all."""
    data = enwik_like(1_500_000, 3)
    want, got = _cli_pair(tmp_path, data, ["-c", "literal", "--block-size", "4096"])
    assert got == want and len(got) == 1_505_936
    back = tmp_path / "back"
    assert pmain(["decompress", "--device", "cpu", str(tmp_path / "port.dctz"), str(back)]) == 0
    assert back.read_bytes() == data


def test_cli_decompress_and_info_read_jax_streams(tmp_path, capsys):
    """A JAX stream of binary and printable frames mixed: the port's CLI
    decompresses it and ``info`` counts every frame."""
    rng = np.random.default_rng(8)
    a, b, c = ascii_text(rng, 3 * BS + 1), ascii_text(rng, 2 * BS), ascii_text(rng, 5000)
    cfg = jx.CodecConfig(block_size=BS, use_device=False)
    stream = io.BytesIO()
    japi.compress_stream(io.BytesIO(a), stream, cfg, batch_blocks=2)
    stream.write(jx.compress(b, cfg, printable=True))
    stream.write(jx.compress(c, jx.CodecConfig(arity=16, block_size=BS, use_device=False)))
    src, back = tmp_path / "mixed", tmp_path / "back"
    src.write_bytes(stream.getvalue())
    assert pmain(["decompress", "--device", "cpu", str(src), str(back)]) == 0
    assert back.read_bytes() == a + b + c
    capsys.readouterr()
    assert pmain(["info", str(src)]) == 0
    info = json.loads(capsys.readouterr().out)
    assert jmain(["info", str(src)]) == 0
    assert json.loads(capsys.readouterr().out) == info
    assert info["frames"] == 4 and info["total_len"] == len(a + b + c)


def test_jax_decodes_the_ports_streams():
    rng = np.random.default_rng(9)
    a, b = ascii_text(rng, 7 * BS + 3), ascii_text(rng, 3 * BS)
    out = io.BytesIO()
    st = papi.compress_stream(io.BytesIO(a), out, pt.CodecConfig(arity=3, block_size=BS),
                              batch_blocks=2, device="cpu")
    assert st["frames"] == 4 and st["raw_bytes"] == len(a)
    papi.compress_stream(io.BytesIO(b), out, pt.CodecConfig(block_size=BS), batch_blocks=2,
                         printable=True, device="cpu")
    back = io.BytesIO()
    st = japi.decompress_stream(io.BytesIO(out.getvalue()), back, jx.CodecConfig(use_device=False))
    assert back.getvalue() == a + b and st["frames"] == 6


def test_stream_stats_equal_jax():
    data = ascii_text(np.random.default_rng(10), 9 * BS + 5)
    jst = japi.compress_stream(io.BytesIO(data), io.BytesIO(),
                               jx.CodecConfig(block_size=BS, use_device=False), batch_blocks=4)
    pst = papi.compress_stream(io.BytesIO(data), io.BytesIO(), pt.CodecConfig(block_size=BS),
                               batch_blocks=4, device="cpu")
    assert pst == jst and pst["frames"] == 3


def test_empty_streams():
    out = io.BytesIO()
    st = papi.compress_stream(io.BytesIO(b""), out, pt.CodecConfig(codec="literal"),
                              device="cpu")
    assert st["frames"] == 1 and st["raw_bytes"] == 0
    assert out.getvalue() == jx.compress(b"", jx.CodecConfig(codec="literal"))
    back = io.BytesIO()
    assert papi.decompress_stream(io.BytesIO(out.getvalue()), back, device="cpu")["frames"] == 1
    assert back.getvalue() == b""
    with pytest.raises(ValueError, match="empty input: no frames"):
        papi.decompress_stream(io.BytesIO(b""), io.BytesIO(), device="cpu")


def test_truncated_stream_raises():
    data = ascii_text(np.random.default_rng(11), 16 * 1024)
    dst = io.BytesIO()
    papi.compress_stream(io.BytesIO(data), dst, pt.CodecConfig(block_size=BS), batch_blocks=2,
                         device="cpu")
    whole = dst.getvalue()
    first = len(pt.compress(data[: 2 * BS], pt.CodecConfig(block_size=BS), device="cpu"))
    assert first < len(whole)
    for cut in (len(whole) - 1, first - 1, first + 1, 10, 3):
        with pytest.raises(ValueError):
            papi.decompress_stream(io.BytesIO(whole[:cut]), io.BytesIO(), device="cpu")


@pytest.mark.parametrize("size,streams", [(8 * BS, False), (8 * BS + 1, True)])
def test_compress_file_streams_above_one_batch(tmp_path, size, streams):
    data = ascii_text(np.random.default_rng(size), size)
    src, out, jout, back = (tmp_path / n for n in ("in", "out", "jout", "back"))
    src.write_bytes(data)
    st = pt.compress_file(str(src), str(out), pt.CodecConfig(block_size=BS), batch_blocks=8,
                          device="cpu")
    jst = jx.compress_file(str(src), str(jout), jx.CodecConfig(block_size=BS, use_device=False),
                           batch_blocks=8)
    assert st == jst and ("frames" in st) == streams
    assert out.read_bytes() == jout.read_bytes()
    if not streams:
        assert out.read_bytes() == pt.compress(data, pt.CodecConfig(block_size=BS), device="cpu")
    assert pt.decompress_file(str(jout), str(back), device="cpu")["raw_bytes"] == size
    assert back.read_bytes() == data
