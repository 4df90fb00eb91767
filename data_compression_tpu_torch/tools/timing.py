"""Kernel timing on a CUDA device, for the profiling tools.

Counterparts of the JAX benchmark's ``time_chain`` and
``measure_envelope``.  Times are CUDA events around launches on one
stream.  Stream order already serialises back-to-back launches, so there
is no dependent chain, no feedback step and no host fetch at the end:
the events hold the launches and nothing else.  Every function here
raises when no CUDA device is available; none falls back to the CPU.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

FLUSH_BYTES = 256 << 20  # > 5x the H100's 50 MB L2
TRIALS = 3
MAX_ITERS = 4096
PROFILE_SESSIONS = 3  # device_ms: sessions tried before it gives up


def require_cuda(device) -> torch.device:
    """``device`` as a torch.device; raises unless it is a CUDA device
    that exists."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"timing needs a CUDA device, got {device!r}")
    return dev


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def _trial_s(step, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        step()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def time_chain(step, *, iters: int = 12, min_trial_s: float = 0.25) -> float:
    """Best seconds per call of ``step()`` launched back to back.

    One warm-up call, then the launch count (from ``iters``) doubles, or
    scales toward 1.2x ``min_trial_s``, until one trial of back-to-back
    launches spans at least ``min_trial_s`` seconds of device time (or
    ``MAX_ITERS`` launches); the result is the best of ``TRIALS`` such
    trials."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_chain needs a CUDA device")
    step()
    torch.cuda.synchronize()
    while True:
        dt = _trial_s(step, iters)
        if dt >= min_trial_s or iters >= MAX_ITERS:
            break
        iters = min(MAX_ITERS, max(iters * 2, int(iters * 1.2 * min_trial_s / max(dt, 1e-9))))
    best = dt / iters
    for _ in range(TRIALS - 1):
        best = min(best, _trial_s(step, iters) / iters)
    return best


def device_ms(step, iters: int = 20) -> float:
    """Mean device ms per call of ``step()``: the summed durations of the
    kernels and copies that ``iters`` calls run on the device, as
    torch.profiler records them, over ``iters``.  Read beside
    ``time_chain``: where the chain's time per call exceeds it, the host's
    enqueue of each call, not the device, sets the chain's pace.  A
    profiler session now and then records no device activity at all (seen
    on an H100 host, at random in a long process); such a session is run
    again, up to ``PROFILE_SESSIONS`` sessions in all.  Raises when none
    records device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA device")
    step()
    torch.cuda.synchronize()
    for _ in range(PROFILE_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                step()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / iters * 1e-3
    raise RuntimeError(f"torch.profiler recorded no device time in {PROFILE_SESSIONS} sessions")


def cold_ms(fn, reps: int, device) -> float:
    """Median ms of ``fn()`` with its inputs cold in L2: before each call,
    outside its events, a ``FLUSH_BYTES`` scratch buffer is rewritten,
    which evicts the L2 and keeps the device busy while the call is
    enqueued (so the events hold no host time)."""
    dev = require_cuda(device)
    scratch = torch.zeros(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    fn()
    pairs = []
    for _ in range(reps):
        scratch.add_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def measure_envelope(device="cuda", min_trial_s: float = 0.25) -> float:
    """Elementwise read + write GB/s of ``a * 2 + 1`` on 64 MiB of int32
    (plain PyTorch, one elementwise kernel: ``1 + 2 * a`` by
    ``torch.add``): the platform envelope the codec's rates are read
    against."""
    dev = require_cuda(device)
    z = torch.arange(64 * 1024 * 1024 // 4, dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    per = time_chain(lambda: torch.add(one, z, alpha=2), iters=16, min_trial_s=min_trial_s)
    return 2 * z.numel() * 4 / per / 1e9
