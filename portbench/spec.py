"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix; the harness reads ``configs/<config>.json``,
``workloads/<traffic>.json``, the timed loop ``drivers/<driver>.py`` that
the traffic names, and one reader ``metrics/<metric>.py`` per metric.  A
new cell, configuration, traffic mix or metric is a new file and a new
entry in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads``, with its configuration and traffic."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the entries of ``end_to_end`` this cell reports
    per_layer: list  # the entries of ``per_layer`` this cell reports


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, root: Path = ROOT, pkg: Path = PKG) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, its files read from
    ``pkg``; KeyError for a cell the file does not name."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_file = Path(root) / configs[w["config"]]["file"]
    traffic = json.loads((Path(pkg) / "workloads" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, ())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=json.loads(cfg_file.read_text()),
                traffic=traffic, end_to_end=e2e, per_layer=layer)


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, pkg: Path = PKG):
    """The timed loop ``drivers/<name>.py``."""
    return _load(Path(pkg) / "drivers" / f"{name}.py", f"portbench_driver_{name}")


def metric_reader(name: str, pkg: Path = PKG):
    """The reader ``metrics/<name>.py`` (a metric's name may hold dots, so
    the file is loaded by path)."""
    return _load(Path(pkg) / "metrics" / f"{name}.py", "portbench_metric_" + name.replace(".", "_"))
