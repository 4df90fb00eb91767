"""Reading the profiler's trace of a traced window.

The device's operations (kernels, copies, memsets) and the benchmark's
host spans (``submit``, ``wait``) are read from the profiler's events in
memory; nothing is written to disk.  The traced window runs from the first
``submit`` span's start to the last ``wait`` span's end.
"""

from __future__ import annotations

import dataclasses
import re

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = ("submit", "wait")
TOP = 10


@dataclasses.dataclass
class Summary:
    window_s: float  # the traced window
    busy_s: float  # seconds of the window in which a device operation ran
    device_s: float  # the device operations' durations, summed
    ops: dict  # short name -> [seconds, count]
    gaps: list  # the longest idle gaps: [host span, seconds]


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces of its own
    file and parameter list, at most 100 characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:100]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label(spans, t):
    """The host span that covers time ``t``, or "host"."""
    for name, a, b in spans:
        if a <= t <= b:
            return name
    return "host"


def _device_op(e) -> bool:
    """A kernel, copy or memset on the device (not an annotation's mirror
    on the device's timeline); torch builds without ``activity_type`` tell
    annotations by their flag and name."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_ACTIVITIES
    return not e.is_user_annotation() and e.name() not in HOST_SPANS


def summarize(prof) -> Summary:
    """-> Summary of a finished ``torch.profiler.profile``."""
    cuda = torch._C._autograd.DeviceType.CUDA
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if _device_op(e):
                device.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.is_user_annotation() and e.name() in HOST_SPANS:
            spans.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    if not spans:
        raise RuntimeError("the trace holds none of the benchmark's host spans")
    spans.sort(key=lambda s: s[1])
    w0 = min(s[1] for s in spans if s[0] == "submit")
    w1 = max(s[2] for s in spans if s[0] == "wait")
    ops = {}
    for name, a, b in device:
        entry = ops.setdefault(short_name(name), [0.0, 0])
        entry[0] += (b - a) * 1e-9
        entry[1] += 1
    busy = _merge((max(a, w0), min(b, w1)) for _, a, b in device if b > w0 and a < w1)
    busy_s = sum(b - a for a, b in busy) * 1e-9
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return Summary(
        window_s=(w1 - w0) * 1e-9, busy_s=busy_s,
        device_s=sum(b - a for _, a, b in device) * 1e-9, ops=ops,
        gaps=[[_label(spans, (a + b) / 2), (b - a) * 1e-9] for a, b in gaps[:TOP]],
    )


def breakdown(summary: Summary) -> dict:
    """The result line's ``breakdown``: the device operations that took
    the most time, and the longest idle gaps by the host span they fall in."""
    top = sorted(summary.ops.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"device_ops": [[name, sec] for name, (sec, _) in top],
            "idle_gaps": [list(g) for g in summary.gaps]}
