"""The per-stage metrics (``enqueue_us.<side>.<stage>``, read by
``portbench/spans.py`` from the program's call recorder) on whole runs of
the tiny cells on the CPU: a traced run reports its side's stages and none
of the other side's, an untraced run none, and a program without the
recorder gives no reading instead of failing."""

import sys
import types

import pytest

from data_compression_tpu_torch import utils
from data_compression_tpu_torch.utils import tracing
from portbench import harness, spans

COMPRESS = ["tiny.huff2.dev.compress.64m", "tiny.huff3.dev.compress.64m"]
DECOMPRESS = ["tiny.huff2.dev.decompress.64m", "tiny.huff3.dev.decompress.64m"]

STAGES = {
    "compress": ["checks", "histogram", "table_build", "encode", "compact", "finish"],
    "decompress": ["checks", "decode_tables", "decode_index", "decode"],
}
NAMES = {side: [f"enqueue_us.{side}.{s}" for s in stages] for side, stages in STAGES.items()}
SEED = 2**31 + 4099


def _side(cell):
    return "compress" if cell in COMPRESS else "decompress"


def _stage_metrics(result):
    return {k: v["value"] for k, v in result["metrics"].items() if k.count(".") == 2}


@pytest.mark.parametrize("cell", COMPRESS + DECOMPRESS)
def test_a_traced_run_reports_its_side_stages(tiny, cell, monkeypatch):
    """In the compress cells the stage sums of the records the metrics
    read are held to the host time around the same calls, matched by the
    host clock: the window's calls (``run.window.calls``)."""
    root, pkg = tiny
    runs = []
    read_metrics = harness._read_metrics

    def keep_run(entries, run, pkg):
        runs.append(run)
        return read_metrics(entries, run, pkg)

    monkeypatch.setattr(harness, "_read_metrics", keep_run)
    result, _ = harness.run_cell(cell, SEED, 1.5, True, device="cpu", root=root, pkg=pkg)
    assert result["correct"]
    got = _stage_metrics(result)
    side = _side(cell)
    assert sorted(got) == sorted(NAMES[side])
    assert all(v > 0 for v in got.values())
    if side == "compress":
        calls = runs[0].window.calls
        records = tracing.recent("device_api.compress", len(calls))
        same = [(t1 - t0, sum(r.stages) / 1e9) for r in records for t0, t1, _ in calls
                if t0 <= r.start_ns / 1e9 and r.start_ns / 1e9 + sum(r.stages) / 1e9 <= t1]
        assert len(same) >= len(records) - 2  # the calls in flight at the close are not the window's
        outside, inside = (sum(x) / len(same) for x in zip(*same))
        assert abs(inside - outside) <= 0.05 * outside


@pytest.mark.parametrize("cell", [COMPRESS[0], DECOMPRESS[0]])
def test_an_untraced_run_reports_no_stage(tiny, cell):
    root, pkg = tiny
    result, _ = harness.run_cell(cell, SEED, 1.0, False, device="cpu", root=root, pkg=pkg)
    assert result["correct"] and result["metrics"] and not _stage_metrics(result)


def test_a_program_without_the_recorder_gives_no_reading(monkeypatch):
    run = types.SimpleNamespace(driver="compress", window=types.SimpleNamespace(calls=[(0, 1, 2)]))
    with tracing.call("device_api.compress") as rec:
        for _ in STAGES["compress"][1:]:
            rec.next_stage()
    assert spans.stage_us(run, "compress", "device_api.compress", "checks") is not None
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "data_compression_tpu_torch.utils.tracing", None)
    assert spans.stage_us(run, "compress", "device_api.compress", "checks") is None
    assert spans.stage_us(run, "decompress", "device_api.compress", "checks") is None
