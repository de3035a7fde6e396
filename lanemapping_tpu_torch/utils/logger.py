"""Logging helpers, port of `lanemapping_tpu/utils/logger.py` (reference
`baseline/utils/logger.py:6-25`): a named logger, a JSONL metric writer,
the program's span and counter recorder and a profiler trace, with
``torch.profiler`` where the JAX package used ``jax.profiler``.

    with trace_span("train.forward"):    # recorded while a profiler runs
        out = model(x)
    count("tiles", len(batch))           # likewise
    if recording():                      # a count the card holds,
        count_device("lanes", mask.sum())  # read by recorded()
    start_profiler_trace(log_dir)        # <log_dir>/profile/trace.json
    ...
    stop_profiler_trace()                # and <log_dir>/profile/spans.json

The recorder.  A span records its name, its start and end
(``perf_counter_ns``), its thread's CPU time over it (``thread_time_ns``),
its thread and its parent (the span open on the same thread when it
began); a counter is a named integer that is added to.  Both record only
while a ``torch.profiler`` runs (``torch.autograd.profiler.
_is_profiler_enabled``): then each span is also a ``record_function``
range, on the trace's clock (a profiler traces the ranges of the thread
that started it; the recorder keeps every thread's spans).  With no profiler running a span is one flag
read and a shared ``nullcontext``, a counter one flag read: no torch call,
no clock, no log line.  A device count (``count_device``) keeps the
tensor it is given and is added to its counter when ``recorded()`` reads
the counters, so the traced forward pass does not wait on the card for
it.  Library builds (nvcc, g++) are one-off set-up
events and are recorded always.  Records stay in memory (at most
``MAX_SPANS`` spans; later ones are counted as dropped); ``recorded()``
hands them out and ``stop_profiler_trace`` writes them as ``spans.json``,
the one exporter.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

import torch.autograd.profiler as _autograd_profiler

_TRACE = {}  # the running profiler and its trace directory
MAX_SPANS = 200_000
_OFF = contextlib.nullcontext()
_spans: List[tuple] = []   # (id, parent, name, thread, name of thread,
#                             start_ns, end_ns, cpu_ns)
_counters: Dict[str, int] = {}
_device_counts: Dict[str, List] = {}  # counter name -> 0-dim tensors
_builds: List[Dict] = []
_dropped = 0
_ids = itertools.count(1)
_open = threading.local()  # the thread's stack of open span ids
_lock = threading.Lock()


def get_logger(name: str = "lanemapping",
               log_file: Optional[str] = None,
               level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricWriter:
    """Append-only JSONL metric stream, one file per tag (the reference's
    TensorBoard scalars and train/val text appenders,
    `runner.py:84,154-157,188-200`)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)

    def write(self, tag: str, record: Dict) -> None:
        with open(os.path.join(self.log_dir, f"{tag}.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")


def recording() -> bool:
    """Whether spans and counters record now: a ``torch.profiler`` runs."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "id", "parent", "stack", "rf", "t0", "c0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        self.parent = stack[-1] if stack else None
        self.stack = stack
        stack.append(self.id)
        self.rf = _autograd_profiler.record_function(self.name)
        self.rf.__enter__()
        # the thread's CPU clock is read inside the wall clock's bracket
        self.t0 = time.perf_counter_ns()
        self.c0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        c1 = time.thread_time_ns()
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        self.stack.pop()
        if len(_spans) < MAX_SPANS:
            th = threading.current_thread()
            _spans.append((self.id, self.parent, self.name, th.ident,
                           th.name, self.t0, t1, c1 - self.c0))
        else:
            _dropped += 1
        return False


def trace_span(name: str):
    """A recorded span and ``record_function`` range while a profiler
    runs; a shared ``nullcontext`` otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def traced(name: str):
    """Decorator: the function's calls as ``trace_span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + int(n)


def count_device(name: str, n) -> None:
    """Add the 0-dim integer tensor ``n`` to the counter ``name`` while a
    profiler runs, without reading it: ``recorded()`` reads it (and so
    waits for the card there).  Compute ``n`` only under ``recording()``."""
    if _autograd_profiler._is_profiler_enabled:
        with _lock:
            _device_counts.setdefault(name, []).append(n.detach())


def record_build(tool: str, library: str, start: float, end: float) -> None:
    """A library built by ``tool`` from ``start`` to ``end``
    (``perf_counter`` seconds): recorded always."""
    with _lock:
        _builds.append({"tool": tool, "library": library, "start": start,
                        "end": end, "seconds": end - start})


def recorded() -> Dict:
    """A copy of what was recorded: ``spans`` (dicts with ``id``,
    ``parent``, ``name``, ``thread``, ``thread_name``, ``start_ns``,
    ``end_ns``, ``cpu_ns``), ``counters``, ``builds`` and ``dropped``."""
    keys = ("id", "parent", "name", "thread", "thread_name", "start_ns",
            "end_ns", "cpu_ns")
    with _lock:
        out = {"spans": [dict(zip(keys, s)) for s in list(_spans)],
               "counters": dict(_counters), "builds": list(_builds),
               "dropped": _dropped}
        pending = {k: list(v) for k, v in _device_counts.items()}
    for k, ts in pending.items():
        out["counters"][k] = out["counters"].get(k, 0) + sum(
            int(t) for t in ts)
    return out


def reset_recorder() -> None:
    """Forget the spans and counters (the builds stay: they are the
    process's)."""
    global _dropped
    with _lock:
        _spans.clear()
        _counters.clear()
        _device_counts.clear()
        _dropped = 0


def start_profiler_trace(log_dir: str) -> None:
    """Start a ``torch.profiler`` trace of the host and, when there is a
    card, of its kernels, with the recorder emptied; ``stop_profiler_trace``
    writes it to ``<log_dir>/profile/trace.json`` (chrome trace format) and
    the recorder's spans and counters to ``spans.json`` beside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _TRACE:
        raise RuntimeError("a profiler trace is already running")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    reset_recorder()
    prof.__enter__()
    _TRACE.update(prof=prof, dir=os.path.join(log_dir, "profile"))


def stop_profiler_trace() -> str:
    """Stop the running trace and write it and the recorder's spans;
    returns the trace file."""
    prof, out = _TRACE.pop("prof"), _TRACE.pop("dir")
    prof.__exit__(None, None, None)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "trace.json")
    prof.export_chrome_trace(path)
    with open(os.path.join(out, "spans.json"), "w") as f:
        json.dump(recorded(), f)
    return path
