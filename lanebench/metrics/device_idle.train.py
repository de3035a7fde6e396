"""The share (%) of the traced stretch in which no kernel, copy or set ran
on the card (the profiler's trace, `lanebench/core.py::Trace`)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
