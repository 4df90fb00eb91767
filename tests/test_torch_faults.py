"""Corrupt frames and payloads that the port once decoded wrongly, on the
CPU: a block table entry whose raw length exceeds the frame's block size
(the decoders sized their output by it and raised MemoryError), and the
small_byte word index 0xFF, which names no slot (the native decoder read
one past its dictionary row where the lanes refuse it).  Every decode
path must raise ValueError, and the native decoder and the lanes must
give the same status.  Tolerance: exact (statuses and bytes).
"""

import io
import struct

import numpy as np
import pytest
import torch
import torch.distributed as dist

import data_compression_tpu_torch as pt
from data_compression_tpu_torch import api, framing, native
from data_compression_tpu_torch.ops import scan_codecs as psc
from data_compression_tpu_torch.ops.kernels import serial_lanes as lanes
from data_compression_tpu_torch.parallel import decompress_sharded, make_mesh
from data_compression_tpu_torch.utils.base64url import z85_core
from data_compression_tpu_torch.utils.corpora import enwik_like
from torch_cases import LANE_KINDS, decoded_as_native

BLOCK = 1024
BAD_RAW_LEN = 0x24000400  # 576 MiB: the first block's raw length after one flipped byte
FIRST_RAW_LEN = framing._HEADER.size + 4  # offset of block 0's raw length


def _corrupt_frame(kind):
    """A 127-block serial-codec frame with block 0's raw length set past
    the block size (the header CRC does not cover the block table)."""
    data = enwik_like(127 * BLOCK, 5)
    frame = pt.compress(data, pt.CodecConfig(codec=kind, block_size=BLOCK), device="cpu")
    assert len(framing.unpack_frame(frame).entries) == 127
    bad = bytearray(frame)
    struct.pack_into("<I", bad, FIRST_RAW_LEN, BAD_RAW_LEN)
    return frame, bytes(bad)


def _printable_of(frame, bad):
    """The printable container of ``bad`` (``frame_to_printable`` itself
    parses, so it is made from ``frame``'s with the block table swapped)."""
    f = framing.unpack_frame(frame)
    lo = framing._HEADER.size
    hi = lo + len(f.entries) * framing._ENTRY.size
    good = framing.frame_to_printable(frame)
    old, new = z85_core(frame[lo:hi]).encode(), z85_core(bad[lo:hi]).encode()
    assert good.count(old) == 1
    return good.replace(old, new)


@pytest.fixture
def gloo1(tmp_path):
    """A gloo world of one rank, destroyed after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    yield make_mesh("cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_block_longer_than_the_block_size_raises_value_error(kind):
    """``unpack_frame``, ``decompress``, ``decompress_stream`` and the
    printable round trip name the block whose raw length exceeds the
    block size; the frame unchanged still decodes."""
    frame, bad = _corrupt_frame(kind)
    assert pt.decompress(frame, device="cpu") == enwik_like(127 * BLOCK, 5)
    match = f"block 0: raw length {BAD_RAW_LEN} exceeds the block size {BLOCK}"
    with pytest.raises(ValueError, match=match):
        framing.unpack_frame(bad)
    with pytest.raises(ValueError, match=match):
        pt.decompress(bad, device="cpu")
    with pytest.raises(ValueError, match=match):
        api.decompress_stream(io.BytesIO(frame + bad), io.BytesIO(), device="cpu")
    printable = _printable_of(frame, bad)
    assert framing.printable_to_frame(printable) == bad
    with pytest.raises(ValueError, match=match):
        pt.decompress(printable, device="cpu")


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_sharded_decompress_checks_block_lengths_first(gloo1, kind):
    """``decompress_sharded`` parses the frame before it looks at the
    codec: the corrupt block length is the error it reports."""
    _, bad = _corrupt_frame(kind)
    with pytest.raises(ValueError, match="block 0: raw length"):
        decompress_sharded(bad, None, gloo1)


def test_small_byte_index_0xff_is_format_on_both_routes():
    """Payload ``08 61 ff`` at raw length 3: index 0xFF names no slot of
    scheme A's 127; the native decoder and the plain decode lane both
    refuse it, and both routes raise ValueError."""
    payload, raw = bytes([0x08, 0x61, 0xFF]), 3
    out, status = lanes.DECODERS["small_byte"](
        torch.tensor(list(payload), dtype=torch.uint8), torch.zeros(1, dtype=torch.int64),
        torch.tensor([3], dtype=torch.int32), torch.tensor([raw], dtype=torch.int32), raw)
    assert status.tolist() == [lanes.FORMAT]
    assert decoded_as_native("small_byte", [payload], [raw], out, status) == 0
    with pytest.raises(ValueError, match="decode error -3"):
        native.small_byte_decode(payload, raw)
    with pytest.raises(ValueError, match="block 0"):
        native.decode_batch("small_byte", [payload], [raw])
    with pytest.raises(ValueError, match="block 0"):
        psc.decode_payloads("small_byte", [payload], [raw], device="cpu")
    with pytest.raises(ValueError):
        psc.small_byte_decode_blocks([payload], [raw], device="cpu")


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_every_one_index_payload_decodes_as_the_native_runtime_does(kind):
    """Every second byte after a first symbol, at raw lengths 2-4: the
    plain decode lane's statuses and bytes equal the native decoder's."""
    type_byte = psc.TYPE_BYTE[kind]
    payloads = [bytes([type_byte, 0x61, i]) for i in range(256)] * 3
    raws = [2 + k // 256 for k in range(len(payloads))]
    plens = np.full(len(payloads), 3, np.int64)
    flat = torch.from_numpy(np.frombuffer(b"".join(payloads), np.uint8).copy())
    out, status = lanes.DECODERS[kind](
        flat, torch.from_numpy(np.arange(len(payloads), dtype=np.int64) * 3),
        torch.from_numpy(plens.astype(np.int32)), torch.tensor(raws, dtype=torch.int32), 4)
    ok = decoded_as_native(kind, payloads, raws, out, status)
    assert 0 < ok < len(payloads)
