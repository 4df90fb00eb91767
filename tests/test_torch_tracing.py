"""The call recorder (``utils/tracing.py``) around the device pipeline's
entry points: one whole record a call that returns, none for a call that
raises, consecutive ids, records whole under threads, the rings' bounds,
and the calls made in a profiler session kept apart on the profiler's
clock.  On the CPU every kernel takes
its plain version; the test marked ``cuda`` holds the stages to the host
time around a call on the card.  Imports no JAX, so that the card can run
it with ``--noconftest``."""

import contextlib
import ctypes
import statistics
import sys
import threading
import time

import numpy as np
import pytest
import torch

from data_compression_tpu_torch import device_api
from data_compression_tpu_torch.config import CodecConfig
from data_compression_tpu_torch.utils import tracing
from data_compression_tpu_torch.utils.corpora import enwik_like

S = 1024  # 8 chunks of 128 symbols a block
COMPRESS, DECOMPRESS = "device_api.compress", "device_api.decompress"


def _inputs(blocks=2, arity=2, device="cpu", block_size=S):
    raw = np.frombuffer(enwik_like(blocks * block_size, 5), dtype=np.uint8)
    data = torch.from_numpy(raw.reshape(blocks, block_size).copy()).to(device)
    lens = torch.full((blocks,), block_size, dtype=torch.int32, device=device)
    return data, lens, CodecConfig(arity=arity, block_size=block_size, chunk_syms=128)


def _compress(device="cpu", **kw):
    data, lens, cfg = _inputs(device=device, **kw)
    return lambda: device_api.compress_blocks_device(data, lens, cfg, device=device)


def _decompress(device="cpu", **kw):
    data, lens, cfg = _inputs(device=device, **kw)
    dc = device_api.compress_blocks_device(data, lens, cfg, device=device)
    inputs = device_api.chunk_inputs(dc)
    return lambda: device_api.decode_blocks_device(*inputs, dc.table_rows, cfg.arity,
                                                   cfg.chunk_syms, device=device)


CALLS = {COMPRESS: _compress, DECOMPRESS: _decompress}


def _newest_id():
    ids = [r.id for e in tracing.STAGES for p in (False, True) for r in tracing.recent(e, 1, p)]
    return max(ids, default=-1)


def _session(profiled):
    """A CPU profiler session, or none."""
    if not profiled:
        return contextlib.nullcontext()
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _whole(record, entry, t0, t1, profiled=False):
    """The record is ``entry``'s, has each stage once, every stage >= 0,
    and lies inside the host interval [t0, t1] taken around the call."""
    assert record.entry == entry and record.profiled is profiled
    assert len(record.stages) == len(tracing.STAGES[entry])
    assert all(isinstance(ns, int) and ns >= 0 for ns in record.stages)
    assert t0 <= record.start_ns and record.start_ns + sum(record.stages) <= t1


def test_stage_names():
    assert tracing.STAGES == {
        COMPRESS: ("checks", "histogram", "table_build", "encode", "compact", "finish"),
        DECOMPRESS: ("checks", "decode_tables", "decode_index", "decode"),
    }
    assert tracing.CAPACITY == 65_536 and tracing.PROFILED_CAPACITY == 4_096


@pytest.mark.parametrize("arity", [2, 3])
@pytest.mark.parametrize("entry", [COMPRESS, DECOMPRESS])
def test_a_call_leaves_one_whole_record(entry, arity):
    fn = CALLS[entry](arity=arity)
    before = tracing.recent(entry, 1)
    last = _newest_id()
    t0 = time.perf_counter_ns()
    fn()
    t1 = time.perf_counter_ns()
    newest = tracing.recent(entry, 2)
    assert newest[-1].id == last + 1
    assert newest[:-1] == before[-1:]  # one record more, the one before unchanged
    _whole(newest[-1], entry, t0, t1)


def test_call_ids_increase_by_one_a_call():
    calls = [_compress(), _decompress(), _compress(arity=3)]
    first = _newest_id() + 1
    for fn in calls:
        fn()
    got = sorted((r.id, r.entry) for e in tracing.STAGES for r in tracing.recent(e, 3)
                 if r.id >= first)
    assert got == [(first, COMPRESS), (first + 1, DECOMPRESS), (first + 2, COMPRESS)]


def _raising(entry):
    """A call of ``entry`` that raises ValueError in its checks."""
    data, lens, cfg = _inputs()
    if entry == COMPRESS:
        return lambda: device_api.compress_blocks_device(data, lens[:1], cfg, device="cpu")
    dc = device_api.compress_blocks_device(data, lens, cfg, device="cpu")
    inputs = device_api.chunk_inputs(dc)
    return lambda: device_api.decode_blocks_device(*inputs, dc.table_rows, device="meta")


@pytest.mark.parametrize("profiled", [False, True])
@pytest.mark.parametrize("entry", [COMPRESS, DECOMPRESS])
def test_a_call_that_raises_leaves_no_record(entry, profiled):
    bad, good = _raising(entry), CALLS[entry]()
    last = _newest_id()
    with _session(profiled):
        with pytest.raises(ValueError):
            bad()
        assert _newest_id() == last
        clock = time.time_ns if profiled else time.perf_counter_ns
        t0 = clock()
        good()
        t1 = clock()
    record = tracing.recent(entry, 1, profiled)[0]
    assert record.id == last + 1
    _whole(record, entry, t0, t1, profiled)


def test_two_threads_compressing_leave_whole_records():
    calls, per_thread = [_compress(), _compress(arity=3)], 3
    errors = []

    def work(fn):
        try:
            for _ in range(per_thread):
                fn()
        except Exception as e:  # noqa: BLE001 -- reported by the test below
            errors.append(e)

    first = _newest_id() + 1
    t0 = time.perf_counter_ns()
    threads = [threading.Thread(target=work, args=(fn,)) for fn in calls]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    t1 = time.perf_counter_ns()
    assert not errors and not any(t.is_alive() for t in threads)
    mine = [r for r in tracing.recent(COMPRESS, 2 * per_thread) if r.id >= first]
    assert [r.id for r in mine] == list(range(first, first + 2 * per_thread))
    for r in mine:
        _whole(r, COMPRESS, t0, t1)


def test_many_threads_on_the_recorder_leave_whole_records():
    """More threads than cores, switching every microsecond, each driving
    the recorder's own entry points: every record keeps its own stamps."""
    threads_n, per_thread = 16, 500
    switch = sys.getswitchinterval()
    first = _newest_id() + 1
    t0 = time.perf_counter_ns()

    def work():
        for _ in range(per_thread):
            with tracing.call(DECOMPRESS) as rec:
                rec.next_stage()
                rec.next_stage()
                rec.next_stage()

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    t1 = time.perf_counter_ns()
    assert not any(t.is_alive() for t in threads)
    mine = [r for r in tracing.recent(DECOMPRESS, threads_n * per_thread) if r.id >= first]
    assert [r.id for r in mine] == list(range(first, first + threads_n * per_thread))
    for r in mine:
        _whole(r, DECOMPRESS, t0, t1)


@pytest.mark.parametrize("profiled", [False, True])
def test_the_ring_keeps_exactly_the_newest_records(profiled):
    capacity = tracing.PROFILED_CAPACITY if profiled else tracing.CAPACITY
    extra = 100
    first = _newest_id() + 1
    with _session(profiled):
        for _ in range(capacity + extra):
            with tracing.call(DECOMPRESS) as rec:
                rec.next_stage()
                rec.next_stage()
                rec.next_stage()
    kept = tracing.recent(DECOMPRESS, 2 * capacity, profiled)
    last = first + capacity + extra - 1
    assert [r.id for r in kept] == list(range(last - capacity + 1, last + 1))
    assert all(r.profiled is profiled for r in kept)
    assert tracing.recent(COMPRESS, 10, profiled) == []  # pushed out
    assert [r.id for r in tracing.recent(DECOMPRESS, 3, profiled)] == [last - 2, last - 1, last]
    assert tracing.recent(DECOMPRESS, 0, profiled) == []


@pytest.mark.parametrize("entry", [COMPRESS, DECOMPRESS])
def test_profiled_calls_are_kept_apart_on_the_profilers_clock(entry):
    """In a profiler session a call's record goes to the profiled ring,
    stamped on the clock of the trace's events: it lies inside a range the
    caller opens around the call and starts within 50 us of the range's
    start (the best of three calls: the host is shared).  The range is a
    ``_RecordFunctionFast``: entering ``record_function`` itself takes
    30-60 us under a CPU profiler.  The recorder adds no range of its own
    to the trace."""
    fn = CALLS[entry]()
    unprofiled = tracing.recent(entry, 1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()  # the session's first ranges cost more
        for i in range(3):
            with torch._C._profiler._RecordFunctionFast(f"probe{i}"):
                fn()
    assert tracing.recent(entry, 1) == unprofiled
    events = prof.profiler.kineto_results.events()
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns()) for e in events}
    records = tracing.recent(entry, 3, profiled=True)
    for i, record in enumerate(records):
        _whole(record, entry, *ranges[f"probe{i}"], profiled=True)
    assert min(r.start_ns - ranges[f"probe{i}"][0] for i, r in enumerate(records)) <= 50_000
    assert not [e for e in events if e.name().startswith("device_api")]
    fn()
    assert not tracing.recent(entry, 1)[0].profiled  # outside the session again


class _Timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


def _c_clock_ns(clock_id):
    """``clock_id`` read by the C library's ``clock_gettime``, as the
    compress chain on the card reads it, not by Python's ``time``."""
    ts = _Timespec()
    assert ctypes.CDLL(None).clock_gettime(clock_id, ctypes.byref(ts)) == 0
    return ts.tv_sec * 1_000_000_000 + ts.tv_nsec


@pytest.mark.parametrize("profiled", [False, True])
def test_stage_ends_stamped_outside_python(profiled):
    """The compress chain's way (``device_api._chain``): the checks ended
    by ``next_stage``, the four kernel stages by clock readings taken in C
    on the call's ``clock_id`` and handed over by ``stamped``, the last by
    the call's end.  The record keeps them in ``STAGES`` order, each >= 0,
    summing to the call's span inside the caller's interval on the
    recorder's clock; a call in a profiler session lands in the profiled
    ring, stamped on the trace's clock."""
    last = _newest_id()
    others = tracing.recent(COMPRESS, 1, not profiled)
    clock = time.time_ns if profiled else time.perf_counter_ns
    with _session(profiled):
        t0 = clock()
        with tracing.call(COMPRESS) as rec:
            rec.next_stage()
            ends = []
            for _ in range(4):
                sum(range(2000))  # a stage's work
                ends.append(_c_clock_ns(rec.clock_id))
            rec.stamped(ends)
        t1 = clock()
    record = tracing.recent(COMPRESS, 1, profiled)[0]
    assert record.id == last + 1 and tracing.recent(COMPRESS, 1, not profiled) == others
    _whole(record, COMPRESS, t0, t1, profiled)
    stage_ends = np.cumsum((record.start_ns,) + record.stages)[1:].tolist()
    assert stage_ends[1:5] == ends and all(st > 0 for st in record.stages[1:5])


def _recorded_nothing():
    """A compress record whose stages hold no work."""
    with tracing.call(COMPRESS) as rec:
        for _ in tracing.STAGES[COMPRESS][1:]:
            rec.next_stage()


def _gaps(fn, calls):
    """Per call of ``fn``: the host time around it and its record's span
    (ns); the device drained between calls."""
    out = []
    for _ in range(calls):
        t0 = time.perf_counter_ns()
        res = fn()
        t1 = time.perf_counter_ns()
        del res  # its frees are the caller's, outside the call
        r = tracing.recent(COMPRESS, 1)[0]
        assert t0 <= r.start_ns and r.start_ns + sum(r.stages) <= t1
        out.append((t1 - t0, sum(r.stages)))
        torch.cuda.synchronize()
    return out


@pytest.mark.cuda
def test_stage_sums_match_the_host_time_on_cuda():
    """The stages of 50 calls on 64 blocks sum to the host time around
    them within 3%, once the recorder's own entry and exit are taken off:
    they lie outside every record by design (the record is written after
    its last stamp), and are read here as the median gap of an empty
    recorded call (2-6 us on the card's host, 3-4% of a 160-230 us call
    of the native chain), which itself has to stay within 8 us."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    fn = _compress(device="cuda", blocks=64, block_size=64 * 1024)
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    own = statistics.median(o - i for o, i in _gaps(lambda: _recorded_nothing(), 50))
    assert own <= 8_000, f"the recorder's own entry and exit take {own} ns a call"
    calls = _gaps(fn, 50)
    outside = sum(o for o, _ in calls)
    inside = sum(i for _, i in calls)
    assert abs(inside - (outside - len(calls) * own)) <= 0.03 * outside
