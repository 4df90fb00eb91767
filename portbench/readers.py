"""What the window's metric readers share: the same reading for each
driver's side, so that a metric file holds only its name's side."""


def rate_GBps(run, driver: str):
    """Raw bytes of every call done in the window over the window's
    seconds, in GB/s (1e9 bytes), host clock; None on the other side."""
    if run.driver != driver:
        return None
    return len(run.window.calls) * run.bytes_per_call / run.window.seconds / 1e9


def enqueue_us(run, driver: str):
    """Mean host microseconds from entering the program's entry point to its
    return, over the untraced calls of the window."""
    calls = run.window.calls
    if run.driver != driver or not calls:
        return None
    return 1e6 * sum(ret - submit for submit, ret, _ in calls) / len(calls)


def idle_pct(run, driver: str):
    """Percent of the traced window in which no operation ran on the device."""
    if run.driver != driver or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
