"""Readings of the numbers that decide ``correct``, for setting their limits.

    python -m portbench.control --workload <cell> --program-seeds S... --control-seeds S...

For each program seed, the cell's inputs are made as a run makes them, the
program's timed call runs once on each input buffer after the warm-up, and
the cell's driver judges the outputs against the plain reference.  For
each control seed the same is done with the driver's ``control`` in the
program's place: the reference with one guarantee of the configuration
broken, which has to come out as not correct.  One process, one JSON line
a seed on standard output, a summary last.
"""

import argparse
import json
import random
import sys
import time

import torch

from portbench import harness, loop, spec


def readings(cell, drv, seed, device, use_control):
    traffic = cell.traffic
    pool = traffic["pool"]
    state = harness.prepare(cell, drv, seed, device)
    if use_control:
        kept = [(buf, drv.control(state, buf)) for buf in range(pool)]
    else:
        call = lambda buf: drv.call(state, buf)  # noqa: E731
        loop.run(call, pool, traffic["in_flight"], device, max_calls=traffic["warmup_calls"])
        sampler = loop.Sampler(2 * pool, random.Random(seed))
        loop.run(call, pool, traffic["in_flight"], device, max_calls=2 * pool, sampler=sampler)
        kept = sampler.kept
    checks, wrong = drv.judge(state, kept)
    return {k: v for k, (v, _) in checks.items()}, wrong, len(kept)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    drv = spec.driver(cell.traffic["driver"])
    most = {"program": {}, "control": {}}
    for side, seeds in (("program", args.program_seeds), ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            got, wrong, judged = readings(cell, drv, seed, device, side == "control")
            print(json.dumps({"workload": args.workload, "side": side, "seed": seed,
                              "numbers": got, "calls_wrong": wrong, "calls_judged": judged,
                              "seconds": time.perf_counter() - t0}), flush=True)
            for k, v in got.items():
                agg = most[side].setdefault(k, [v, v])
                agg[0], agg[1] = min(agg[0], v), max(agg[1], v)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps({"workload": args.workload, "device": name,
                      "program_min_max": most["program"], "control_min_max": most["control"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
