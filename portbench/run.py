"""Run one cell of BENCHMARK.json on the chip and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs from the seed, loads the program and warms
up its calls; the window then runs for ``--seconds``.  The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared, with its limit); the same numbers
are the last lines of standard error.  Without as many CUDA devices as the
cell asks for, or with JAX or the JAX package loaded after the window, it
exits non-zero and prints no result.
"""

import time

T_PROCESS = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def _args(argv):
    p = argparse.ArgumentParser(prog="python -m portbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="any whole number")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: report the per-layer metrics, read from a profiler trace")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    from portbench import spec

    chips = spec.cell(args.workload).chips
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell {args.workload} needs {chips} CUDA device(s), found {found}; "
              "no result", file=sys.stderr)
        return 2
    from portbench import harness

    result, lines = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                     device="cuda", t_start=T_PROCESS)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"portbench: modules loaded that the program may not use: {', '.join(foreign)}; "
              "no result", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
