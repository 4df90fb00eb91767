"""setup_s: host seconds from the start of the run's process to the start of
the window: imports, the kernel library's load (its build in a checkout's
first run), the inputs made from the seed and the warm-up calls."""


def read(run):
    return run.setup_s
