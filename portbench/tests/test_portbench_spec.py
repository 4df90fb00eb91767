"""BENCHMARK.json and the files the harness finds by name."""

import json
import re
import subprocess
import sys

import pytest

from portbench import harness, spec
from portbench.tests.conftest import tiny_copy

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_benchmark_json_has_the_contracts_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_parse(cfg):
    data = json.loads((spec.ROOT / cfg["file"]).read_text())
    assert cfg["file"].startswith("portbench/configs/") and data["name"] == cfg["name"]
    assert "per_block_tables" in data["guarantees"] and data["max_code_digits"] == 15


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files_and_reports_what_it_must(cell):
    c = spec.cell(cell["name"])
    assert spec.driver(c.traffic["driver"]).call
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e  # each per-layer metric moves one this cell reports


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.metric_reader(metric["name"]).read)
    if metric["unit"] == "%" and "roofline" in metric["name"]:
        assert metric["name"].split(".")[0].endswith("_roofline")


def test_a_cell_added_as_files_only_is_found_and_runs(tmp_path):
    root, pkg = tiny_copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    traffic = json.loads((pkg / "workloads" / "tiny.dev.compress.64m.json").read_text())
    traffic["in_flight"] = 1
    (pkg / "workloads" / "one.in.flight.json").write_text(json.dumps(traffic))
    bench["workloads"].append({"name": "huff2.one", "config": "huff2-enwik8-64k",
                               "traffic": "one.in.flight", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "huff2.dev.compress.64m" in m.get("workloads", ()):
            m["workloads"].append("huff2.one")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = harness.run_cell("huff2.one", 5, 0.3, False, device="cpu", root=root, pkg=pkg)
    assert result["correct"] and set(result["metrics"]) == {"compress_GBps", "call_ms_p95",
                                                            "setup_s"}


def test_no_jax_or_jax_package_is_loaded():
    code = ("import sys; from portbench import harness, spec; import portbench.reference.huffman; "
            "[spec.driver(d) for d in ('compress', 'decompress')]; "
            "print(harness.foreign_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"  # the drivers loaded data_compression_tpu_torch, which is allowed


def test_without_a_card_the_command_prints_no_result():
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
                          cwd=spec.ROOT, capture_output=True, text=True,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA device" in proc.stderr
