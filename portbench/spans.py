"""The program's own stage times, read from its call recorder
(``data_compression_tpu_torch/utils/tracing.py``): what the per-stage
metrics share, so that a metric file holds only its side and stage.

The recorder keeps the host time of each stage of the newest calls of
each entry point made outside a profiler session.  A program without it
(before it had one) gives no reading, and the metrics that read it are
left out of the line."""


def stage_us(run, driver: str, entry: str, stage: str):
    """Mean host microseconds of ``stage`` of ``entry`` (a key of the
    recorder's ``STAGES``) over the newest ``len(run.window.calls)``
    records of calls made outside a profiler session; None on the other
    side, when the window has no call, or when the program has no
    recorder."""
    if run.driver != driver or not run.window.calls:
        return None
    try:
        from data_compression_tpu_torch.utils import tracing
    except ImportError:
        return None
    k = tracing.STAGES[entry].index(stage)
    ns = [r.stages[k] for r in tracing.recent(entry, len(run.window.calls))]
    return sum(ns) / len(ns) / 1e3 if ns else None
