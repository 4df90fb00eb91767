"""Stage byte counts of the roofline readers on a hand-worked batch: two
blocks of 1,024 bytes in chunks of 512, one of a single byte value and one
of two values alternating.  Every code is then one binary digit, so each
chunk takes 512 / 8 = 64 wire bytes and the payload is 4 x 64 = 256 bytes;
the counts follow from these shapes and output sizes alone."""

import types

import pytest
import torch

from portbench import spec
from portbench.drivers import compress, decompress

B, S, C = 2, 1024, 512
RAW = B * S
CHUNKS = B * S // C
PAYLOAD = CHUNKS * 64
L = 15


def _cell():
    cfg = {"arity": 2, "block_size": S, "chunk_syms": C, "max_code_digits": L}
    return types.SimpleNamespace(config=cfg)


def _inputs():
    raw = torch.empty((B, S), dtype=torch.uint8)
    raw[0] = ord("a")
    raw[1, 0::2], raw[1, 1::2] = ord("a"), ord("b")
    return [raw], [torch.full((B,), S, dtype=torch.int32)]


def test_compress_stage():
    buffers, lens = _inputs()
    state = compress.prepare(_cell(), buffers, lens, torch.device("cpu"))
    out = compress.call(state, 0)
    assert out.nb.tolist() == [[64, 64], [64, 64]]
    compress.note(state, 0, out)
    s = compress.stage(state)
    assert s == {"blocks": B, "block_size": S, "chunks": CHUNKS, "raw_bytes": RAW,
                 "code_digits": L, "payload_bytes": PAYLOAD}
    expected = {
        "histogram_roofline": RAW + B * 256 * 4,  # raw read, 256 four-byte counts a block
        "table_build_roofline": B * 256 * (4 + 1 + 4),  # counts in, lengths and codes out
        "encode_roofline": RAW + B * 256 * 4 + PAYLOAD + CHUNKS * 4,
        "compact_roofline": 2 * PAYLOAD + B * 4,
        "pipeline_roofline.compress": RAW + PAYLOAD + B * 256 + CHUNKS * 4,
    }
    for name, nbytes in expected.items():
        assert spec.metric_reader(name).stage_bytes(s) == nbytes, name


def test_decompress_stage():
    buffers, lens = _inputs()
    state = decompress.prepare(_cell(), buffers, lens, torch.device("cpu"))
    assert state.frames[0].chunk_bytes.tolist() == [[64, 64], [64, 64]]
    s = decompress.stage(state)
    assert s["payload_bytes"] == PAYLOAD and s["chunks"] == CHUNKS and s["raw_bytes"] == RAW
    expected = {
        "decode_tables_roofline": B * (256 + 256 + 2 * (L + 1) * 4),
        "decode_roofline": PAYLOAD + CHUNKS * 16 + B * (256 + 2 * (L + 1) * 4) + RAW,
        "pipeline_roofline.decompress": PAYLOAD + B * 256 + CHUNKS * 16 + RAW,
    }
    for name, nbytes in expected.items():
        assert spec.metric_reader(name).stage_bytes(s) == nbytes, name
    out = decompress.call(state, 0)
    checks, wrong = decompress.judge(state, [(0, out)])
    assert wrong == 0 and checks["symbols_differing"] == (0, 0)


@pytest.mark.parametrize("name", ["histogram_roofline", "encode_roofline", "decode_roofline",
                                  "pipeline_roofline.compress"])
def test_a_share_needs_a_trace(name):
    run = types.SimpleNamespace(trace=None, traced_calls=0, driver="compress",
                                stage={"blocks": B, "block_size": S, "chunks": CHUNKS,
                                       "raw_bytes": RAW, "code_digits": L,
                                       "payload_bytes": PAYLOAD})
    assert spec.metric_reader(name).read(run) is None


def test_a_kernel_share_reads_the_mean_launch():
    ops = {"huffman_encode_kernel<2>": [2e-6, 2], "compact_kernel": [1.0, 1]}
    run = types.SimpleNamespace(trace=types.SimpleNamespace(ops=ops, device_s=1.0),
                                traced_calls=2, driver="compress",
                                stage={"blocks": B, "block_size": S, "chunks": CHUNKS,
                                       "raw_bytes": RAW, "code_digits": L,
                                       "payload_bytes": PAYLOAD})
    got = spec.metric_reader("encode_roofline").read(run)
    nbytes = RAW + B * 256 * 4 + PAYLOAD + CHUNKS * 4
    assert got == pytest.approx(100 * nbytes / 3.35e12 / 1e-6)
