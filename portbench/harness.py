"""One run of one cell: set-up, the measured window, the check, the metrics.

``run_cell`` is ``run.py``'s body without the look for a chip, so that the
tests drive a whole run on the CPU at a small size.
"""

from __future__ import annotations

import dataclasses
import gc
import random
import sys
import time
from pathlib import Path

import torch

from portbench import corpus, loop, spec
from portbench import trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "data_compression_tpu")
TRACE_SECONDS = 3.0  # the traced part of a --trace 1 window; the rest runs untraced


@dataclasses.dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``: ``read(run)``)."""

    driver: str
    setup_s: float
    window: loop.Window  # the untraced part of the window
    bytes_per_call: int  # raw bytes a call compresses or decompresses
    stage: dict  # byte counts of one call (the driver's ``stage``)
    trace: object = None  # trace.Summary of the traced part, or None
    traced_calls: int = 0


def foreign_modules() -> list:
    """Loaded modules whose top-level name is the JAX package's or JAX's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _read_metrics(entries, run: Run, pkg: Path) -> dict:
    out = {}
    for m in entries:
        value = spec.metric_reader(m["name"], pkg).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def prepare(cell: spec.Cell, drv, seed: int, device: torch.device):
    """The cell's input buffers from ``seed``, full blocks, handed to the
    driver's ``prepare``.  -> the driver's state."""
    cfg, traffic = cell.config, cell.traffic
    buffers = corpus.make_buffers(cfg["corpus"], traffic["pool"], traffic["blocks_per_call"],
                                  cfg["block_size"], seed, device)
    lens = [torch.full((b.shape[0],), b.shape[1], dtype=torch.int32, device=device)
            for b in buffers]
    return drv.prepare(cell, buffers, lens, device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float = None, root: Path = spec.ROOT, pkg: Path = spec.PKG) -> tuple:
    """-> (result dict, check lines).  ``t_start`` is the host time set-up
    is counted from (the process's start in ``run.py``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = spec.cell(workload, root, pkg)
    traffic = cell.traffic
    drv = spec.driver(traffic["driver"], pkg)
    pool, in_flight, keep = traffic["pool"], traffic["in_flight"], traffic["sample_calls"]
    t_inputs = time.perf_counter()
    state = prepare(cell, drv, seed, device)
    call = lambda buf: drv.call(state, buf)  # noqa: E731
    t_warm = time.perf_counter()

    # warm-up: the window's own calls, outputs kept as the window keeps them
    loop.run(call, pool, in_flight, device, max_calls=traffic["warmup_calls"],
             sampler=loop.Sampler(keep, random.Random(0)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t_window = time.perf_counter()
    print(f"set-up: {t_inputs - t_start:.3f} s to the inputs, {t_warm - t_inputs:.3f} s inputs "
          f"and driver, {t_window - t_warm:.3f} s warm-up", file=sys.stderr, flush=True)
    sampler = loop.Sampler(keep, random.Random(seed))
    note = lambda buf, out: drv.note(state, buf, out)  # noqa: E731
    summary, traced, submitted = None, 0, 0
    gc.collect()
    gc.disable()
    try:
        if trace:
            part = min(TRACE_SECONDS, seconds / 2)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                setup_s = time.perf_counter() - t_start
                traced_window = loop.run(call, pool, in_flight, device, seconds=part,
                                         sampler=sampler, on_done=note, annotate=True)
            traced = traced_window.submitted
            window = loop.run(call, pool, in_flight, device, seconds=seconds - part,
                              sampler=sampler, on_done=note)
            submitted = traced + window.submitted
            if not window.calls:  # a window too short for an untraced part
                window = traced_window
        else:
            setup_s = time.perf_counter() - t_start
            window = loop.run(call, pool, in_flight, device, seconds=seconds, sampler=sampler,
                              on_done=note)
            submitted = window.submitted
    finally:
        gc.enable()
    if trace:
        summary = tracing.summarize(prof)
        del prof
        print(f"trace: {traced} calls traced, {summary.window_s:.6f} s window, "
              f"{summary.device_s:.6f} s of device operations", file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run = Run(driver=traffic["driver"], setup_s=setup_s, window=window,
              bytes_per_call=drv.raw_bytes(state), stage=drv.stage(state), trace=summary,
              traced_calls=traced)
    kept = sampler.kept
    del sampler
    t_check = time.perf_counter()
    checks, wrong = drv.judge(state, kept)
    print(f"check: {time.perf_counter() - t_check:.3f} s", file=sys.stderr, flush=True)
    judged = len(kept)
    del kept
    checks["calls_unjudged"] = (int(judged == 0), 0)  # a window with no call done judges nothing
    correct = wrong == 0 and all(v <= lim for v, lim in checks.values())
    metrics = _read_metrics(cell.per_layer if trace else cell.end_to_end, run, pkg)
    result = {
        "correct": correct,
        "attempted": submitted,
        "failed": wrong,
        "metrics": metrics,
        "device": _device(device, cell.chips, peak, summary),
    }
    if summary is not None:
        result["breakdown"] = tracing.breakdown(summary)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    lines = [f"check {k}: {v} (limit {lim})" for k, (v, lim) in checks.items()]
    return result, lines


def _device(device: torch.device, count: int, peak: int, summary) -> dict:
    if device.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
               "memory_peak_bytes": peak}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": peak}
    if summary is not None:
        out["busy_s"] = summary.busy_s
        out["window_s"] = summary.window_s
    return out
