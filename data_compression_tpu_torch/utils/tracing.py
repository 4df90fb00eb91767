"""The call recorder: the host time of each stage of the device pipeline's
entry points, kept for their newest calls.

``device_api.compress_blocks_device`` and ``decode_blocks_device`` run their
bodies under ``call(entry)`` and stamp the host clock at each boundary
between their stages (``STAGES[entry]``, in order).  A call that returns
writes one record into a preallocated ring of the newest ``CAPACITY`` calls
of both entry points; a call that raises writes none.  The recorder is
always on: a call pays for its stamps (``time.perf_counter_ns``) and one
record write of 72 bytes, no more.  The record in progress belongs to the
call, so calls on several threads do not mix stamps.  ``recent(entry, n)``
reads the ring.

A call made while a ``torch.profiler`` session runs is stamped on the
profiler's clock instead (``time.time_ns``, the Unix-epoch nanoseconds of
the trace's events) and kept apart, in a ring of the newest
``PROFILED_CAPACITY`` such calls, flagged ``profiled``: so the calls of a
traced window can be laid over its device trace, and do not push the
untraced calls out.  The recorder adds no range to the trace: ranges of
its own would slow the host, which the profiler already slows, and move
the trace's idle time.
"""

from __future__ import annotations

import itertools
import struct
import time
from typing import NamedTuple

import numpy as np
from torch.autograd import profiler as _profiler

STAGES = {
    "device_api.compress": ("checks", "histogram", "table_build", "encode", "compact", "finish"),
    "device_api.decompress": ("checks", "decode_tables", "decode_index", "decode"),
}
CAPACITY = 65_536  # records kept, the newest of both entry points together
PROFILED_CAPACITY = 4_096  # the same for calls made while a profiler session ran

# A record is int64 words: the call id, the entry's code (its index + 1,
# doubled) | profiled, then the clock at the call's entry and at the end of
# each stage.  Code 0 marks a slot never written.
_WIDTH = 3 + max(len(s) for s in STAGES.values())
_RECORD = 8 * _WIDTH  # bytes
_CODE = {entry: (i + 1) << 1 for i, entry in enumerate(STAGES)}
_ring = bytearray(_RECORD * CAPACITY)
_profiled_ring = bytearray(_RECORD * PROFILED_CAPACITY)
_ids = itertools.count()
_clock = time.perf_counter_ns
_profiler_clock = time.time_ns


class Record(NamedTuple):
    id: int  # the call's id, process-wide, one more for each recorded call
    entry: str
    start_ns: int  # the clock at the call's entry: perf_counter_ns, or time_ns if profiled
    stages: tuple  # ns of each stage of STAGES[entry], in order; they sum to the call's span
    profiled: bool  # made while a torch.profiler session ran


class _Call(list):
    """One call of an entry point: the clock at its entry and at the end of
    each stage so far.  A subclass for each entry point holds its record's
    code and layout as class attributes, so that a call costs no more than
    its stamps and the write."""

    __slots__ = ()
    pack = code = None

    def __enter__(self):
        return self

    def next_stage(self) -> None:
        """End the current stage and start the next."""
        self.append(_clock())

    def __exit__(self, kind, value, tb):
        if kind is None:
            self.append(_clock())
            i = next(_ids)
            self.pack(_ring, _RECORD * (i % CAPACITY), i, self.code, *self)


class _ProfiledCall(_Call):
    """A call made while a profiler session runs: the profiler's clock, the
    profiled ring."""

    __slots__ = ()

    def next_stage(self) -> None:
        self.append(_profiler_clock())

    def __exit__(self, kind, value, tb):
        if kind is None:
            self.append(_profiler_clock())
            i = next(_ids)
            self.pack(_profiled_ring, _RECORD * (i % PROFILED_CAPACITY), i, self.code, *self)


def _entry_class(base, entry: str, profiled: int):
    """``base`` for one entry point, its record's code and layout as class
    attributes."""
    return type(base.__name__ + entry.replace(".", "_"), (base,), {
        "__slots__": (), "code": _CODE[entry] | profiled,
        "pack": struct.Struct(f"<{3 + len(STAGES[entry])}q").pack_into})


_PLAIN = {entry: _entry_class(_Call, entry, 0) for entry in STAGES}
_PROFILED = {entry: _entry_class(_ProfiledCall, entry, 1) for entry in STAGES}


def call(entry: str) -> _Call:
    """The recorder of one call of ``entry`` (a key of STAGES), a context
    manager: its body calls ``next_stage()`` at each boundary between two
    stages, and a body that returns writes the record."""
    if _profiler._is_profiler_enabled:
        return _PROFILED[entry]((_profiler_clock(),))
    return _PLAIN[entry]((_clock(),))


def recent(entry: str, n: int, profiled: bool = False) -> list:
    """The newest ``n`` records of ``entry`` (fewer if the ring holds fewer),
    oldest first, from the ring of calls made outside a profiler session,
    or with ``profiled`` from the ring of those made inside one.
    -> [Record]."""
    code = _CODE[entry] | profiled
    ring = _profiled_ring if profiled else _ring
    rows = np.frombuffer(bytes(ring), dtype="<i8").reshape(-1, _WIDTH)
    rows = rows[rows[:, 1] == code]
    rows = rows[np.argsort(rows[:, 0])][len(rows) - max(0, min(n, len(rows))):]
    stages = np.diff(rows[:, 2:3 + len(STAGES[entry])], axis=1).tolist()
    return [Record(i, entry, start, tuple(st), bool(c & 1))
            for (i, c, start), st in zip(rows[:, :3].tolist(), stages)]
