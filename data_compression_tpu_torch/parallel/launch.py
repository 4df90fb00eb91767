"""Start the ranks of a local process group as child processes.

One rank is one process with one device: gloo on the CPU, or NCCL with
rank r on ``cuda:r``.  Used by ``parallel.dryrun`` and
``tools.scaling_bench``; the children find the package through
``PYTHONPATH``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BACKENDS = {"cpu": "gloo", "cuda": "nccl"}


def require_cards(n_ranks: int, device: str) -> None:
    """ValueError unless ``device`` is cpu or cuda and, on cuda, the
    machine has a card for every rank (nothing falls back to the CPU)."""
    if device not in BACKENDS:
        raise ValueError(f"device must be one of {sorted(BACKENDS)}, got {device!r}")
    if device == "cuda" and torch.cuda.device_count() < n_ranks:
        raise ValueError(f"{n_ranks} NCCL ranks need {n_ranks} CUDA devices; this machine "
                         f"has {torch.cuda.device_count()}")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_method() -> str:
    return f"tcp://127.0.0.1:{free_port()}"


def run_ranks(argv_of: Callable[[int], Sequence[str]], n_ranks: int, timeout: float,
              prefix_of: Optional[Callable[[int], Sequence[str]]] = None) -> List[str]:
    """Run ``python <argv_of(r)>`` for each rank r (behind
    ``prefix_of(r)``, e.g. a ``taskset``), all at once; -> their standard
    outputs, by rank.  The first rank to fail, or the time limit, kills
    the others and raises RuntimeError with that rank's standard error."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    outs = [tempfile.TemporaryFile("w+") for _ in range(n_ranks)]
    errs = [tempfile.TemporaryFile("w+") for _ in range(n_ranks)]
    procs = []
    try:
        for r in range(n_ranks):
            prefix = list(prefix_of(r)) if prefix_of else []
            procs.append(subprocess.Popen(prefix + [sys.executable, *argv_of(r)],
                                          stdout=outs[r], stderr=errs[r], env=env, cwd=ROOT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                r = failed[0]
                errs[r].seek(0)
                raise RuntimeError(f"rank {r} of {n_ranks} failed (exit {codes[r]}):\n"
                                   f"{errs[r].read()[-3000:]}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"the {n_ranks} ranks did not finish in {timeout} s")
            time.sleep(0.05)
        result = []
        for f in outs:
            f.seek(0)
            result.append(f.read())
        return result
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in outs + errs:
            f.close()
