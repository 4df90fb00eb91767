"""The closed loop every driver's calls run in.

One caller keeps ``in_flight`` calls in flight on the current stream: it
submits call i + in_flight once call i's completion event has fired,
cycling through ``pool`` input buffers.  A call's host times are taken at
its submission, at the return of the program's entry point (the enqueue),
and when the host sees its completion event.  Calls that complete inside
the window are the window's; a seeded reservoir keeps ``keep`` of their
outputs, drawn uniformly from all of them, for the check after the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from collections import deque

import torch


class _HostEvent:
    """A completion event for CPU tensors: the work is done on return."""

    def record(self):
        pass

    def synchronize(self):
        pass


@dataclasses.dataclass
class Sampler:
    """A reservoir of ``keep`` (buffer, output) pairs over the calls it is
    offered, drawn with ``rng``."""

    keep: int
    rng: random.Random
    seen: int = 0
    kept: list = dataclasses.field(default_factory=list)

    def offer(self, buf: int, out) -> None:
        self.seen += 1
        if len(self.kept) < self.keep:
            self.kept.append((buf, out))
            return
        r = self.rng.randrange(self.seen)
        if r < self.keep:
            self.kept[r] = (buf, out)


@dataclasses.dataclass
class Window:
    """What one run of the loop saw."""

    seconds: float  # the window's length on the host clock
    submitted: int  # calls submitted (those still in flight at the close included)
    calls: list  # (submit, enqueued, done) host times of every call done in the window


def run(call, pool: int, in_flight: int, device: torch.device, seconds: float = None,
        max_calls: int = None, sampler: Sampler = None, on_done=None, annotate: bool = False):
    """Run ``call(buf) -> output`` in the closed loop until ``seconds`` have
    passed (or ``max_calls`` are submitted), then wait for the calls in
    flight.  -> Window."""
    make = torch.cuda.Event if device.type == "cuda" else _HostEvent
    ring = [make() for _ in range(in_flight)]
    span = torch.profiler.record_function if annotate else (lambda _name: contextlib.nullcontext())
    pending = deque()
    calls = []
    i, stop = 0, False
    t_start = time.perf_counter()
    t_end = t_start + seconds if seconds is not None else float("inf")
    while True:
        while not stop and len(pending) < in_flight:
            buf = i % pool
            with span("submit"):
                t0 = time.perf_counter()
                out = call(buf)
                t1 = time.perf_counter()
                ev = ring[i % in_flight]
                ev.record()
            pending.append((buf, out, ev, t0, t1))
            i += 1
            if max_calls is not None and i >= max_calls:
                stop = True
        if not pending:
            break
        buf, out, ev, t0, t1 = pending.popleft()
        with span("wait"):
            ev.synchronize()
        t2 = time.perf_counter()
        if t2 <= t_end:
            calls.append((t0, t1, t2))
            if sampler is not None:
                sampler.offer(buf, out)
            if on_done is not None:
                on_done(buf, out)
        else:
            stop = True
    length = seconds if seconds is not None else time.perf_counter() - t_start
    return Window(seconds=length, submitted=i, calls=calls)
