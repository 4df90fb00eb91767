"""Where a 64 MiB round trip spends its time, on a CUDA device.

    python -m data_compression_tpu_torch.tools.e2e [--arities 2 16 3] [--mb 64] [--device cuda]

For each Huffman arity, on ``mb`` MiB of ``chip_smoke.py``'s input (the
seeded enwik-like corpus with one deep-code block last): one warm-up
round trip, then ``compress`` and ``decompress`` through the public API,
each
  * timed alone on the host clock (best of 3, ``wall_ms``),
  * under cProfile once (``profiled_ms``, and the ``TOP`` functions by
    own time: [name, own ms, cumulative ms, calls]; the table build is
    ``capped_lengths_batch``'s cumulative ms, ``tables_ms``),
  * under torch.profiler: the device ms per call (``timing.device_ms``,
    kernels and copies; null where not measured) and the device's busy
    share of ``wall_ms``.
Prints one JSON line per (arity, op), after a header line with
the card (``nvidia-smi`` name and power limit), the host CPU's model
name and ``os.cpu_count()``.  Raises when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import sys
import time

import torch

from data_compression_tpu_torch import CodecConfig, compress, decompress
from data_compression_tpu_torch.tools import timing
from data_compression_tpu_torch.utils.corpora import deep_code_block, enwik_like

MIB = 1 << 20
SEED = 7  # chip_smoke.py's
TOP = 12  # functions listed per call, by own time


def cpu_model() -> str:
    """The host CPU's model name from /proc/cpuinfo; where a virtual
    machine reports it "unknown", its vendor, family and model numbers."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's fields only
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    name = info.get("model name", "unknown")
    if name != "unknown":
        return name
    return (f"{info.get('vendor_id', '?')} family {info.get('cpu family', '?')} "
            f"model {info.get('model', '?')} (model name unknown)")


def _profile(fn):
    """(profiled ms, table-build ms, top rows) of one call."""
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(fn)
    ms = (time.perf_counter() - t0) * 1e3
    st = pstats.Stats(prof)
    rows = []
    tables = 0.0
    for (path, line, name), (_, calls, own, cum, _) in st.stats.items():
        if name == "capped_lengths_batch":
            tables += cum * 1e3
        rows.append([f"{os.path.basename(path)}:{line}({name})", own * 1e3, cum * 1e3, calls])
    rows.sort(key=lambda r: -r[1])
    return ms, tables, rows[:TOP]


def run(cfg: CodecConfig, data: bytes, device) -> list:
    """The two JSON rows (compress, decompress) of one configuration."""
    blob = compress(data, cfg, device=device)
    if decompress(blob, device=device) != data:
        raise AssertionError(f"{cfg} round trip is not exact")
    rows = []
    for op, fn in (("compress", lambda: compress(data, cfg, device=device)),
                   ("decompress", lambda: decompress(blob, device=device))):
        wall = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        prof_ms, tables_ms, top_rows = _profile(fn)
        dev_ms = timing.device_ms_or_none(fn, iters=3)
        rows.append({"arity": cfg.arity, "op": op, "mb": len(data) / MIB,
                     "wall_ms": min(wall), "gbps": len(data) / (min(wall) * 1e-3) / 1e9,
                     "profiled_ms": prof_ms, "tables_ms": tables_ms, "device_ms": dev_ms,
                     "device_busy": None if dev_ms is None else dev_ms / min(wall),
                     "top": top_rows})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m data_compression_tpu_torch.tools.e2e")
    ap.add_argument("--arities", type=int, nargs="*", default=[2, 16, 3])
    ap.add_argument("--mb", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = timing.require_cuda(args.device)
    print(json.dumps({"card": timing.card(), "device": torch.cuda.get_device_name(dev),
                      "host_cpu": cpu_model(), "cpu_count": os.cpu_count(), "mb": args.mb}))
    data = enwik_like(args.mb * MIB - 64 * 1024, SEED) + deep_code_block(64 * 1024, SEED)
    for n in args.arities:
        for row in run(CodecConfig(arity=n), data, dev):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
