"""Fixtures of the benchmark's CPU tests: a copy of the benchmark whose
cells are cut to a few blocks, so that a whole run fits a test."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from portbench import spec

TINY_BLOCKS = 4


def tiny_copy(dest: Path, blocks: int = TINY_BLOCKS) -> tuple:
    """Copy BENCHMARK.json and ``portbench/`` under ``dest`` and add, beside
    every cell, a cell ``tiny.<name>`` on a traffic mix of ``blocks`` blocks
    a call, as new files and entries only.  -> (root, pkg)."""
    root, pkg = Path(dest), Path(dest) / "portbench"
    shutil.copytree(spec.PKG, pkg, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.benchmark()
    for w in list(bench["workloads"]):
        traffic = json.loads((pkg / "workloads" / f"{w['traffic']}.json").read_text())
        traffic.update(blocks_per_call=blocks, warmup_calls=3)
        (pkg / "workloads" / f"tiny.{w['traffic']}.json").write_text(json.dumps(traffic))
        name = f"tiny.{w['name']}"
        bench["workloads"].append(dict(w, name=name, traffic=f"tiny.{w['traffic']}"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in m.get("workloads", ()):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root, pkg


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("portbench"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
