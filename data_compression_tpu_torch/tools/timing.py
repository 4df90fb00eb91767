"""Kernel timing on a CUDA device, for the profiling tools.

Counterparts of the JAX benchmark's ``time_chain`` and
``measure_envelope``.  Times are CUDA events around launches on one
stream.  Stream order already serialises back-to-back launches, so there
is no dependent chain, no feedback step and no host fetch at the end:
the events hold the launches and nothing else.  ``time_chain`` lets the
host enqueue as the device runs, so a call whose enqueue outlasts its
kernels is timed at the host's pace; ``device_ms`` holds the stream
behind a spin kernel until every call is enqueued, so it times the
device alone.  ``profiled_device_ms`` sums torch.profiler's device
records instead, for whole API calls that read back to the host.  Every
function here raises when no CUDA device is available; none falls back
to the CPU.
"""

from __future__ import annotations

import statistics
import subprocess
import time
import warnings

import torch

FLUSH_BYTES = 256 << 20  # > 5x the H100's 50 MB L2
TRIALS = 3
MAX_ITERS = 4096
GATE_MIN_MS = 1.0  # device_ms: shortest spin that holds the stream
GATE_TRIES = 5  # device_ms: gated chains tried, the spin 4x longer each time
CALIBRATION_CYCLES = 10_000_000  # device_ms: spin cycles timed once per process
PROFILE_SESSIONS = 6  # profiled_device_ms: sessions of each kind tried before it gives up
WINDOW_PAD_S = 0.05  # profiled_device_ms: first idle host time at each end of a session
MAX_WINDOW_PAD_S = 0.4  # profiled_device_ms: the pad doubles after each session not whole

_cycles_per_ms = None  # the spin kernel's clock, measured at the first device_ms


class UngatedChain(RuntimeError):
    """No spin of ``device_ms`` outlasted the host's enqueue of the calls."""


class IncompleteProfile(RuntimeError):
    """No torch.profiler session of ``profiled_device_ms`` held every
    device record."""


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


def _spin_cycles_per_ms() -> float:
    """Clock cycles per ms of ``torch.cuda._sleep``, timed once by CUDA
    events around one spin of ``CALIBRATION_CYCLES``."""
    global _cycles_per_ms
    if _cycles_per_ms is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(CALIBRATION_CYCLES)
        end.record()
        end.synchronize()
        _cycles_per_ms = CALIBRATION_CYCLES / max(start.elapsed_time(end), 1e-6)
    return _cycles_per_ms


def _gated_chain(step, iters: int, gate_ms: float):
    """(ms per call, whether the gate held) of ``iters`` calls of
    ``step()`` enqueued behind a spin kernel of ``gate_ms``: the start
    event waits for the spin, so if the spin is still running when the
    host has enqueued the end event, the events hold the calls back to
    back with no host time between them.  The calls run under
    ``torch.cuda.set_sync_debug_mode("error")``: a call that reads back
    to the host raises instead of being timed."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = int(gate_ms * _spin_cycles_per_ms())
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            step()
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    held = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / iters, held


def device_ms(step, iters: int = 20) -> float:
    """Mean device ms per call of ``step()``: ``iters`` calls back to
    back on the device, timed by CUDA events that a spin kernel holds
    until the host has enqueued every call, so no host enqueue is in the
    reading and it is never below the calls' summed kernel time (the
    device's gaps between launches are in it).  Read beside
    ``time_chain``: where the chain's time per call exceeds it, the
    host's enqueue of each call, not the device, sets the chain's pace.

    The spin lasts 3x the host's enqueue of one untimed chain, at least
    ``GATE_MIN_MS``; a chain whose spin ended before the enqueue did is
    run again with a spin 4x longer, up to ``GATE_TRIES`` chains, then
    raises UngatedChain.  A call that synchronises with the host raises
    RuntimeError (sync debug mode "error")."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA device")
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    gate = max(GATE_MIN_MS, 3e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    tried = []
    for _ in range(GATE_TRIES):
        ms, held = _gated_chain(step, iters, gate)
        if held:
            return ms
        tried.append(gate)
        gate *= 4
    raise UngatedChain(f"the host's enqueue of {iters} calls outlasted every spin "
                       f"({', '.join(f'{g:.1f}' for g in tried)} ms)")


def _device_records(step, calls: int, pad_s: float):
    """(device records, their summed µs) of ``calls`` calls of ``step()``
    in one torch.profiler session: the kernels and copies it recorded.
    The session's window is padded by ``pad_s`` of idle host time at each
    end: a device record reaches the host clock through an estimate, and
    the profiler drops records it places outside the window, so a record
    near either end could otherwise go missing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(events), sum(e.device_time_total for e in events)


def profiled_device_ms(step, iters: int = 20) -> float:
    """Mean device ms per call of ``step()`` as torch.profiler records
    it: the summed durations of the kernels and copies that ``iters``
    calls run on the device, over ``iters``.  For whole API calls, which
    read back to the host and so cannot run behind ``device_ms``'s gate;
    the device's share of such a call is this over its wall time.

    A profiler session may drop records: on an H100 host a session now and
    then held none, and late in a long process every one-call session of
    some steps held none, padded or not.  So a first session of one call
    counts the device records per call (run again while it holds none),
    and a timed session counts only when it holds exactly ``iters`` times
    that many.  A session that falls short is run again with its window
    pad doubled (from ``WINDOW_PAD_S`` up to ``MAX_WINDOW_PAD_S``; see
    ``_device_records``), up to ``PROFILE_SESSIONS`` of each kind; raises
    IncompleteProfile, naming the counts, when none is whole."""
    if not torch.cuda.is_available():
        raise RuntimeError("profiled_device_ms needs a CUDA device")
    step()
    torch.cuda.synchronize()
    pad = WINDOW_PAD_S
    counted = []
    while len(counted) < PROFILE_SESSIONS and not any(counted):
        if counted:
            pad = min(2 * pad, MAX_WINDOW_PAD_S)
        counted.append(_device_records(step, 1, pad)[0])
    want = counted[-1] * iters
    seen = []
    while want and len(seen) < PROFILE_SESSIONS:
        if seen:
            pad = min(2 * pad, MAX_WINDOW_PAD_S)
        n, us = _device_records(step, iters, pad)
        if n == want:
            return us / iters * 1e-3
        seen.append(n)
    raise IncompleteProfile(
        f"torch.profiler recorded no whole session: the one-call sessions held {counted} "
        f"device records, so {want} were expected of {iters} calls; the timed sessions "
        f"held {seen}"
    )


def profiled_device_ms_or_none(step, iters: int = 20):
    """``profiled_device_ms``, or None (not measured, with a
    RuntimeWarning that names the counts) where no profiler session was
    whole: for readings that sit beside a wall time and check nothing."""
    try:
        return profiled_device_ms(step, iters)
    except IncompleteProfile as e:
        warnings.warn(f"device time not measured: {e}", RuntimeWarning, stacklevel=2)
        return None


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
