"""call_ms_p95: the 95th percentile (nearest rank), over every call done in
the window, of the host time from submitting a call to seeing its
completion event, in ms."""

import math


def read(run):
    times = sorted(done - submit for submit, _, done in run.window.calls)
    if not times:
        return None
    return 1e3 * times[math.ceil(0.95 * len(times)) - 1]
