"""Scaling efficiency of the sharded encode step: 1 process against N.

    python -m data_compression_tpu_torch.tools.scaling_bench [nprocs] [mb] \\
        [--device cuda|cpu] [--out FILE] [--timeout SECONDS]

The counterpart of the repo-root ``tools/scaling_bench.py``.  Runs
``parallel.multihost.measure_encode_throughput`` over the same ``mb``
MiB corpus in a topology of 1 rank, then in one of ``nprocs`` ranks
(``nprocs`` may be 1), each rank a child process pinned by ``taskset``
to a core of its own (round robin over this process's cores), so that
per-process compute is equal across topologies and the ratio

    efficiency = (bytes_per_s_N / N) / bytes_per_s_1

isolates the protocol's overhead.  One device a rank: gloo on the CPU,
or NCCL with rank r on ``cuda:r`` (ValueError when the machine has fewer
cards than ranks; nothing falls back to the CPU).  Each rank reports its
compute and collective seconds (the all-gather of the per-chunk byte
counts), so a low efficiency is attributable.

Prints one JSON report with the repo-root tool's keys, plus ``device``
and, on cuda, the card's ``name`` and ``power.limit``; writes it to
``--out`` when given and nowhere else.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from data_compression_tpu_torch.parallel.launch import (
    BACKENDS, init_method, require_cards, run_ranks,
)

_WORKER = r"""
import json, sys
import torch
import torch.distributed as dist
from data_compression_tpu_torch.config import CodecConfig
from data_compression_tpu_torch.parallel import multihost

init, rank, nproc, nbytes, device = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
dev = torch.device("cuda", rank) if device == "cuda" else None
multihost.initialize("nccl" if device == "cuda" else "gloo", init, nproc, rank, device=dev)
try:
    cfg = CodecConfig(codec="huffman", arity=2, block_size=65536, chunk_syms=512)
    r = multihost.measure_encode_throughput(cfg, nbytes, device=dev or "cpu")
finally:
    dist.destroy_process_group()
print("THROUGHPUT " + json.dumps(r), flush=True)
"""


def run_topology(nproc: int, nbytes: int, device: str, timeout: float = 600) -> dict:
    """``measure_encode_throughput`` in ``nproc`` pinned ranks; -> rank
    0's report."""
    require_cards(nproc, device)
    init = init_method()
    cores = sorted(os.sched_getaffinity(0))
    outs = run_ranks(lambda r: ["-c", _WORKER, init, str(r), str(nproc), str(nbytes), device],
                     nproc, timeout,
                     prefix_of=lambda r: ["taskset", "-c", str(cores[r % len(cores)])])
    line = [ln for ln in outs[0].splitlines() if ln.startswith("THROUGHPUT ")][-1]
    return json.loads(line.split(" ", 1)[1])


def card() -> dict:
    """The card's ``name`` and ``power.limit`` as nvidia-smi prints them."""
    from data_compression_tpu_torch.tools import timing

    name, power = timing.card().rsplit(",", 1)
    return {"name": name.strip(), "power.limit": power.strip()}


def run(nproc: int, mb: int, device: str, timeout: float = 600) -> dict:
    """Both topologies; -> the report."""
    require_cards(nproc, device)
    nbytes = mb * 1024 * 1024
    r1 = run_topology(1, nbytes, device, timeout)
    rN = run_topology(nproc, nbytes, device, timeout)
    eff = (rN["bytes_per_s"] / nproc) / r1["bytes_per_s"]
    report = {
        "metric": "multihost_scaling_efficiency",
        "value": round(eff, 4),
        "unit": "fraction (per-process throughput at N procs / 1 proc)",
        "processes": nproc,
        "devices_per_process": 1,
        "corpus_mb": mb,
        "single_proc": r1,
        "multi_proc": rN,
        "cores": os.cpu_count(),
        "note": f"one {BACKENDS[device]} rank a process and one device a rank ({device}), "
        "one pinned core per process (incl. the P=1 baseline): the ratio isolates "
        "protocol overhead; compute_s vs collective_s in the worker reports attributes "
        "any residual",
        "device": device,
    }
    if device == "cuda":
        report.update(card())
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("nprocs", type=int, nargs="?", default=2)
    ap.add_argument("mb", type=int, nargs="?", default=4)
    ap.add_argument("--device", choices=sorted(BACKENDS), default="cuda")
    ap.add_argument("--out", help="write the JSON report to this file")
    ap.add_argument("--timeout", type=float, default=600,
                    help="seconds a topology may take before its ranks are killed")
    args = ap.parse_args(argv)
    report = run(args.nprocs, args.mb, args.device, args.timeout)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
