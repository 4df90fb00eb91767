"""``correct`` on a whole run, driven on the CPU at a few blocks: true for
the program, false with a fault planted in its timed path, and false for
the control (the reference with one guarantee broken) in its place."""

import pytest
import torch

from data_compression_tpu_torch import device_api
from portbench import harness, spec

COMPRESS = ["tiny.huff2.dev.compress.64m", "tiny.huff3.dev.compress.64m"]
DECOMPRESS = ["tiny.huff2.dev.decompress.64m", "tiny.huff3.dev.decompress.64m"]


def _run(tiny, cell, seed=2**31 + 77):
    root, pkg = tiny
    result, lines = harness.run_cell(cell, seed, 1.5, False, device="cpu", root=root, pkg=pkg)
    assert result["checks"]["calls_unjudged"]["value"] == 0
    assert len(lines) == len(result["checks"])
    return result


@pytest.mark.parametrize("cell", COMPRESS + DECOMPRESS)
def test_the_program_is_correct(tiny, cell):
    result = _run(tiny, cell)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"


def _half_batch_compress(blocks, raw_lens, config=None, out_cap=None, device="cuda"):
    half = blocks.shape[0] // 2
    return _real_compress(blocks[:half], raw_lens[:half], config, out_cap, device)


def _altered_compress(*args, **kw):
    dc = _real_compress(*args, **kw)
    dc.flat[17] ^= 1
    return dc


def _unchanged_compress(blocks, raw_lens, config=None, out_cap=None, device="cuda"):
    dc = _real_compress(blocks, raw_lens, config, out_cap, device)
    dc.flat.zero_()
    return dc


def _half_batch_decode(flat, chunk_off, chunk_cnt, chunk_blk, table_rows, **kw):
    out = _real_decode(flat, chunk_off, chunk_cnt, chunk_blk, table_rows, **kw)
    out[out.shape[0] // 2:] = 0
    return out


def _altered_decode(*args, **kw):
    out = _real_decode(*args, **kw)
    out[1, 3] ^= 0x40
    return out


def _unchanged_decode(flat, chunk_off, chunk_cnt, chunk_blk, table_rows, **kw):
    K = chunk_cnt.shape[0]
    return torch.zeros((K, kw.get("chunk_syms", 512)), dtype=torch.uint8)


_real_compress = device_api.compress_blocks_device
_real_decode = device_api.decode_blocks_device
FAULTS = {
    "compress_blocks_device": {"half_batch": _half_batch_compress, "altered": _altered_compress,
                               "unchanged": _unchanged_compress},
    "decode_blocks_device": {"half_batch": _half_batch_decode, "altered": _altered_decode,
                             "unchanged": _unchanged_decode},
}


@pytest.mark.parametrize("fault", ["half_batch", "altered", "unchanged"])
@pytest.mark.parametrize("cell", COMPRESS + DECOMPRESS)
def test_a_planted_fault_is_not_correct(tiny, cell, fault, monkeypatch):
    entry = "decode_blocks_device" if cell in DECOMPRESS else "compress_blocks_device"
    monkeypatch.setattr(device_api, entry, FAULTS[entry][fault])
    result = _run(tiny, cell)
    assert not result["correct"]
    assert result["failed"] >= 1
    assert any(c["value"] > c["limit"] for k, c in result["checks"].items() if k != "calls_unjudged")


@pytest.mark.parametrize("cell", COMPRESS + DECOMPRESS)
def test_the_control_is_not_correct(tiny, cell):
    root, pkg = tiny
    c = spec.cell(cell, root, pkg)
    drv = spec.driver(c.traffic["driver"], pkg)
    from portbench import control

    got, wrong, judged = control.readings(c, drv, 3, torch.device("cpu"), True)
    assert wrong == judged == c.traffic["pool"]
    assert max(got.values()) > 0


@pytest.mark.parametrize("cell", [COMPRESS[1], DECOMPRESS[0]])
def test_the_program_reads_zero_on_a_dozen_seeds(tiny, cell):
    root, pkg = tiny
    c = spec.cell(cell, root, pkg)
    drv = spec.driver(c.traffic["driver"], pkg)
    from portbench import control

    for seed in range(12):
        got, wrong, _ = control.readings(c, drv, 1000 + seed, torch.device("cpu"), False)
        assert wrong == 0 and not any(got.values()), (seed, got)


@pytest.mark.cuda
def test_runs_on_the_card(tiny, cuda_device):
    root, pkg = tiny
    for cell in COMPRESS + DECOMPRESS:
        result, _ = harness.run_cell(cell, 4, 0.5, True, device=cuda_device, root=root, pkg=pkg)
        assert result["correct"] and result["device"]["busy_s"] > 0
