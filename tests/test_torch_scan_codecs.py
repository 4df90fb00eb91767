"""The serial codecs' lanes on the CPU: ``ops/kernels/serial_lanes.py``'s
plain versions and ``ops/scan_codecs.py`` against the JAX package's
``ops/scan_codecs.py`` lanes (JAX on the CPU) and the port's native and
Python host codecs; the codecs' routes by device; corrupt payloads.

Inputs are made with numpy from a seed (``torch_cases.lane_blocks``).
Tolerance: exact — payloads, rows, totals, statuses and outputs compared
with ==.
"""

import numpy as np
import pytest
import torch

import data_compression_tpu.ops.scan_codecs as jsc

import data_compression_tpu_torch as pt
from data_compression_tpu_torch import native
from data_compression_tpu_torch.models import nybble as pnyb
from data_compression_tpu_torch.models import small as psmall
from data_compression_tpu_torch.ops import scan_codecs as psc
from data_compression_tpu_torch.ops.kernels import serial_lanes as lanes
from data_compression_tpu_torch.utils.corpora import (
    enwik_like,
    long_small_blocks,
    printable_like,
    payload_mix,
    tight_span_payload,
)
from data_compression_tpu_torch.utils.debug import CodecStats
from torch_cases import LANE_KINDS, decoded_as_native, lane_blocks

# block sizes: the slot-wrap rows of tests/test_small.py (5000 bytes of
# 1-23 for small_byte, 4000 of 1-15 for small_nybble)
SIZES = {"nybble": 4000, "small_byte": 5000, "small_nybble": 4000}
HOST = {
    "nybble": (pnyb.encode_host, pnyb.decode_host),
    "small_byte": (psmall.small_byte_encode_host, psmall.small_byte_decode_host),
    "small_nybble": (psmall.small_nybble_encode_host, psmall.small_nybble_decode_host),
}
SEVEN_BIT = {"nybble": True, "small_byte": True, "small_nybble": False}


def _expected(kind, blocks, lengths):
    """The native route's payloads; raw blocks where the scheme is 7-bit
    and the block is not."""
    out = []
    for b, n in zip(blocks, lengths):
        raw = b[:n].tobytes()
        if SEVEN_BIT[kind] and n and max(raw) >= 0x80:
            out.append(raw)
        else:
            out.append(getattr(native, f"{kind}_encode")(raw))
    return out


def _flat(payloads):
    plens = np.array([len(p) for p in payloads], np.int64)
    offsets = np.concatenate([[0], np.cumsum(plens)[:-1]]).astype(np.int64)
    flat = np.frombuffer(b"".join(payloads), np.uint8).copy()
    return (torch.from_numpy(flat), torch.from_numpy(offsets),
            torch.from_numpy(plens.astype(np.int32)))


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_encode_lanes_match_jax_native_and_host(kind):
    """The plain encode lane (through ``ops/scan_codecs``) gives the JAX
    lane's payloads, the native route's and the Python host encoder's;
    its rows hold each payload at its total."""
    blocks, lengths = lane_blocks(kind, SIZES[kind], 81)
    want = _expected(kind, blocks, lengths)
    got = getattr(psc, f"{kind}_encode_blocks")(blocks, lengths, device="cpu")
    assert got == want
    assert getattr(jsc, f"{kind}_encode_blocks")(blocks, lengths) == want
    rows, totals, status = lanes.ENCODERS[kind](torch.from_numpy(blocks),
                                                 torch.from_numpy(lengths))
    for i, (b, n) in enumerate(zip(blocks, lengths)):
        raw = b[:n].tobytes()
        if SEVEN_BIT[kind] and n and max(raw) >= 0x80:
            assert (int(status[i]), int(totals[i])) == (lanes.INPUT, 0)
        else:
            assert int(status[i]) == lanes.OK
            assert rows[i, : int(totals[i])].numpy().tobytes() == want[i] == HOST[kind][0](raw)


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_decode_lanes_match_jax_native_and_host(kind):
    """The plain decode lane gives back every block of the native
    payloads, as the JAX lane and the host decoder do."""
    blocks, lengths = lane_blocks(kind, SIZES[kind], 82)
    keep = [i for i, (b, n) in enumerate(zip(blocks, lengths))
            if not (SEVEN_BIT[kind] and n and b[:n].max() >= 0x80)]
    raws = [blocks[i, : lengths[i]].tobytes() for i in keep]
    payloads = [getattr(native, f"{kind}_encode")(r) for r in raws]
    lens = [len(r) for r in raws]
    assert getattr(psc, f"{kind}_decode_blocks")(payloads, lens, device="cpu") == raws
    assert getattr(jsc, f"{kind}_decode_blocks")(payloads, lens) == raws
    assert [HOST[kind][1](p, n) for p, n in zip(payloads, lens)] == raws


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_one_block_is_a_batch(kind):
    x = b"the cat sat on the mat. " * 3
    blocks = np.frombuffer(x, np.uint8)[None, :].copy()
    enc = getattr(psc, f"{kind}_encode_blocks")(blocks, [len(x)], device="cpu")
    assert enc == getattr(jsc, f"{kind}_encode_blocks")(blocks, np.array([len(x)]))
    assert getattr(psc, f"{kind}_decode_blocks")(enc, [len(x)], device="cpu") == [x]


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_corrupt_payloads_raise(kind):
    """A wrong type byte (JAX's message), a truncated payload, and for
    small_byte the index 0xFF past its 127 slots, raise ValueError; the
    other blocks of the batch decode right."""
    x = enwik_like(3000, 83)
    good = getattr(native, f"{kind}_encode")(x)
    dec = getattr(psc, f"{kind}_decode_blocks")
    with pytest.raises(ValueError, match=f"block 1: bad {kind} stream type byte"):
        dec([good, b"\x00" + good[1:]], [len(x)] * 2, device="cpu")
    with pytest.raises(ValueError, match=f"{kind} decode lane: block 1"):
        dec([good, good[: len(good) // 2]], [len(x)] * 2, device="cpu")
    with pytest.raises(ValueError, match="block 0"):
        dec([good[:1]], [len(x)], device="cpu")
    if kind == "small_byte":
        with pytest.raises(ValueError, match="small_byte decode lane: block 0"):
            dec([bytes([8, 0x41, 0xFF])], [5], device="cpu")
    out, status = lanes.DECODERS[kind](*_flat([good, good[:-40], good]),
                                       torch.tensor([len(x)] * 3, dtype=torch.int32), len(x))
    assert status.tolist() == [lanes.OK, lanes.FORMAT, lanes.OK]
    assert out[0].numpy().tobytes() == out[2].numpy().tobytes() == x


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_random_payloads_decode_as_the_native_runtime_does(kind):
    """On random payload bytes behind a right type byte the plain decode
    lane refuses exactly the blocks the native decoder refuses, and gives
    the native decoder's bytes for the rest (small_byte's 0xFF, which
    names no slot, included)."""
    rng = np.random.default_rng(84)
    type_byte = psc.TYPE_BYTE[kind]
    payloads, raw_lens = [], []
    for k in range(24):
        body = rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8).tobytes()
        payloads.append(bytes([type_byte]) + body)
        raw_lens.append(int(rng.integers(0, 60)))
    payloads[0] = b""  # raw length 0 decodes to nothing whatever the payload
    raw_lens[0] = 0
    out, status = lanes.DECODERS[kind](*_flat(payloads),
                                       torch.tensor(raw_lens, dtype=torch.int32), max(raw_lens))
    for i, (p, n) in enumerate(zip(payloads, raw_lens)):
        try:
            want = getattr(native, f"{kind}_decode")(p, n)
        except ValueError:
            want = None
        if want is None:
            assert int(status[i]) == lanes.FORMAT, i
        else:
            assert int(status[i]) == lanes.OK, i
            assert out[i, :n].numpy().tobytes() == want, i
    assert {int(s) for s in status} == {lanes.OK, lanes.FORMAT}


@pytest.mark.parametrize("kind", ["small_byte", "small_nybble"])
def test_plain_small_decoders_on_the_deepest_words(kind):
    """Crafted streams whose spans grow one symbol every two steps, each
    source ending exactly where its span is written
    (``tight_span_payload``), and the same cut two symbols short: the
    plain decode lane, whose gather window is fixed for WINDOW_STEPS
    steps at a time, gives the native decoder's bytes and statuses, and
    the JAX lane's bytes."""
    S = 3000
    crafted = [tight_span_payload(kind, S, seed) for seed in (0, 1)]
    payloads = [p for p, _ in crafted] * 2
    raws = [n for _, n in crafted] + [n - 2 for _, n in crafted]
    out, status = lanes.DECODERS[kind](*_flat(payloads), torch.tensor(raws, dtype=torch.int32), S)
    assert status.tolist() == [lanes.OK, lanes.OK, lanes.FORMAT, lanes.FORMAT]
    want = [getattr(native, f"{kind}_decode")(p, n) for p, n in crafted]
    assert [out[i, :n].numpy().tobytes() for i, (_, n) in enumerate(crafted)] == want
    assert getattr(jsc, f"{kind}_decode_blocks")(payloads[:2], raws[:2]) == want
    # the card tests' mix of crafted, corrupted, cut and random payloads
    real = getattr(native, f"{kind}_encode")(enwik_like(S, 85))
    payloads, raws = payload_mix(kind, S, 8, 86, real)
    out, status = lanes.DECODERS[kind](*_flat(payloads), torch.tensor(raws, dtype=torch.int32), S)
    decoded_as_native(kind, payloads, raws, out, status)


def test_lane_checks():
    assert [lanes.row_width(k, 4096) for k in LANE_KINDS] == [4098, 4097, 8192]
    assert [lanes.row_width(k, 0) for k in LANE_KINDS] == [1, 1, 1]
    with pytest.raises(ValueError, match="no serial lane"):
        lanes.row_width("huffman", 10)
    u8 = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match=r"\[B, S\] uint8"):
        lanes.nybble_encode(u8.int(), torch.zeros(2))
    with pytest.raises(ValueError, match="lengths"):
        lanes.small_byte_encode(u8, torch.zeros(3, dtype=torch.int32))
    flat, offs, plens = _flat([b"\x08a", b"\x08b"])
    with pytest.raises(ValueError, match="raw_lens"):
        lanes.small_nybble_decode(flat, offs, plens, torch.zeros(2, dtype=torch.int64), 4)
    with pytest.raises(ValueError, match="at most"):
        lanes.nybble_decode(flat, offs, plens, torch.zeros(2, dtype=torch.int32),
                            lanes.MAX_BLOCK + 1)
    assert psc.encode_payloads("nybble", np.zeros((0, 4), np.uint8), []) == []
    assert psc.decode_payloads("small_byte", [], []) == []


@pytest.mark.parametrize("count", [0, 1, 5])
def test_plain_steps_run_count_times_on_the_cpu(count):
    """``_Steps.run`` calls the step ``count`` times on the CPU (on a card
    the first call, then graph replays), and again on a second run."""
    calls = []
    steps = lanes._Steps(lambda: calls.append(len(calls)), torch.device("cpu"))
    steps.run(count)
    assert calls == list(range(count))
    steps.run(2)
    assert calls == list(range(count + 2))


def test_every_lane_kernel_has_a_layout_and_an_occupancy_query():
    """The layout's words come from the launch's numbers (the card test
    reads those off each kernel); a name that is no lane is refused
    before anything is built."""
    assert lanes.layout_text(32, 1, 16384) == ("a warp a block, 1 block(s) a CTA, "
                                               "16,384 B of shared memory a CTA")
    assert lanes.layout_text(1, 1, 32896).startswith("a thread a block, 1 block(s) a CTA, 32,896 B")
    assert lanes.layout_text(8, 8, 1024).startswith("a thread a block, 8 block(s) a CTA, 1,024 B")
    assert lanes.layout_text(64, 1, 27696).startswith("2 warps a block, 1 block(s) a CTA, 27,696 B")
    for name in ("huffman_encode", "small_byte", "small_byte_rows"):
        with pytest.raises(ValueError, match="no serial lane"):
            lanes.lane_occupancy(name)


@pytest.mark.parametrize("kind,S", [("small_byte", 24 << 20), ("small_nybble", 16 << 20)])
def test_long_lane_blocks_write_a_slot_past_16_bits(kind, S):
    """The card test's long blocks do what it says they do: by the native
    encoder, the one-context block's words write every slot of context 1
    more than 65,535 times, and scheme A refuses the block with the top
    bit set on its last byte."""
    blocks = long_small_blocks(S, 98)
    words = len(getattr(native, f"{kind}_encode")(blocks[0].tobytes())) - 2
    assert (words - 1) // (128 if kind == "small_nybble" else 127) > 65535
    if kind == "small_byte":
        with pytest.raises(ValueError):
            native.small_byte_encode(blocks[2].tobytes())


# ---- the codecs' routes ---------------------------------------------------


def _spy(monkeypatch, module, name, calls, replace=None):
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append((name, a, k))
        return (replace or real)(*a, **k)

    monkeypatch.setattr(module, name, spy)


CONFIGS = {"nybble": {"codec": "nybble"}, "small_byte": {"codec": "small_byte"},
           "small_byte_isprint": {"codec": "small_byte", "isprint_literal": True},
           "small_nybble": {"codec": "small_nybble"}}


def _route_input():
    return (enwik_like(5000, 85) + printable_like(2048, 86)
            + bytes(range(256)) * 4 + enwik_like(1000, 87))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cpu_codecs_keep_the_native_route(name, monkeypatch):
    calls = []
    _spy(monkeypatch, native, "encode_batch", calls)
    _spy(monkeypatch, native, "decode_batch", calls)
    for fn in ("encode_payloads", "decode_payloads"):
        _spy(monkeypatch, psc, fn, calls, replace=lambda *a, **k: pytest.fail("lane on cpu"))
    cfg = pt.CodecConfig(block_size=2048, **CONFIGS[name])
    x = _route_input()
    assert pt.decompress(pt.compress(x, cfg, device="cpu"), device="cpu") == x
    assert {c[0] for c in calls} == {"encode_batch", "decode_batch"}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cuda_codecs_take_the_lanes(name, monkeypatch):
    """Made for cuda (a card faked, the lanes run on the CPU), every
    type-8 / 0xAF block goes through ``scan_codecs`` and none through
    the native runtime; the frame is the cpu frame."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []
    for fn in ("encode_batch", "decode_batch"):
        _spy(monkeypatch, native, fn, calls,
             replace=lambda *a, **k: pytest.fail("native route on cuda"))
    for fn in ("encode_payloads", "decode_payloads"):
        real = getattr(psc, fn)

        def on_cpu(*a, _real=real, **k):
            assert torch.device(a[-1] if len(a) == 4 else k["device"]).type == "cuda"
            return _real(*a[:3], device="cpu")

        _spy(monkeypatch, psc, fn, calls, replace=on_cpu)
    cfg = pt.CodecConfig(block_size=2048, **CONFIGS[name])
    x = _route_input()
    frame = pt.compress(x, cfg, device="cuda")
    assert pt.decompress(frame, device="cuda") == x
    assert {c[0] for c in calls} == {"encode_payloads", "decode_payloads"}
    monkeypatch.undo()
    assert frame == pt.compress(x, cfg, device="cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stats_take_the_host_encoder_on_any_device(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for module, fns in ((native, ("encode_batch",)), (psc, ("encode_payloads",))):
        for fn in fns:
            monkeypatch.setattr(module, fn, lambda *a, **k: pytest.fail("not the host encoder"))
    cfg = pt.CodecConfig(block_size=2048, **CONFIGS[name])
    codec = pt.get_codec(cfg, "cuda")
    blocks = np.frombuffer(_route_input()[:8192], np.uint8).reshape(4, 2048).copy()
    lengths = np.full(4, 2048)
    got = codec.encode_blocks(blocks, lengths, stats=CodecStats(32)).payloads
    monkeypatch.undo()
    assert got == pt.get_codec(cfg, "cpu").encode_blocks(blocks, lengths).payloads


def test_isprint_blocks_take_the_host_coder_on_cuda(monkeypatch):
    """0x1f blocks have no lane: on cuda they ride the host isprint coder,
    the frame's type-8 blocks the lane."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    lane_rows = []

    def encode(kind, blocks, lengths, device):
        lane_rows.append(blocks.shape[0])
        return real_encode(kind, blocks, lengths, device="cpu")

    real_encode = psc.encode_payloads
    monkeypatch.setattr(psc, "encode_payloads", encode)
    cfg = pt.CodecConfig(codec="small_byte", isprint_literal=True, block_size=4096)
    printable = printable_like(8192, 88)
    x = printable + bytes(range(1, 127)) * 40 + printable
    frame = pt.compress(x, cfg, device="cuda")
    assert lane_rows == [2]  # the two blocks with control bytes
    monkeypatch.undo()
    assert frame == pt.compress(x, cfg, device="cpu")


def test_device_stages_needs_a_card(monkeypatch):
    """The stage timing tool, which also times the lanes, never falls
    back to the CPU."""
    from data_compression_tpu_torch.tools import device_stages

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        device_stages.main([])
