"""Logging helpers, port of `lanemapping_tpu/utils/logger.py` (reference
`baseline/utils/logger.py:6-25`): a named logger, a JSONL metric writer, a
traced span and a profiler trace, with ``torch.profiler`` where the JAX
package used ``jax.profiler``.

    with trace_span("forward"):          # a named range in a torch trace
        out = model(x)
    start_profiler_trace(log_dir)        # <log_dir>/profile/trace.json
    ...
    stop_profiler_trace()
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Optional

_TRACE = {}  # the running profiler and its trace directory


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


@contextlib.contextmanager
def trace_span(name: str):
    """A ``torch.profiler.record_function`` range (seen by a running
    profiler, free otherwise) and a wall-clock debug line.  The wall
    clock is the host's: on the card it times the enqueueing, not the
    kernels."""
    import torch

    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    get_logger().debug("%s took %.1f ms", name, dt * 1e3)


def start_profiler_trace(log_dir: str) -> None:
    """Start a ``torch.profiler`` trace of the host and, when there is a
    card, of its kernels; ``stop_profiler_trace`` writes it to
    ``<log_dir>/profile/trace.json`` (chrome trace format)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _TRACE:
        raise RuntimeError("a profiler trace is already running")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    _TRACE.update(prof=prof, dir=os.path.join(log_dir, "profile"))


def stop_profiler_trace() -> str:
    """Stop the running trace and write it; returns the trace file."""
    prof, out = _TRACE.pop("prof"), _TRACE.pop("dir")
    prof.__exit__(None, None, None)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "trace.json")
    prof.export_chrome_trace(path)
    return path
