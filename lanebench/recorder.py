"""What the program recorded of itself: its spans, counters and library
builds (`lanemapping_tpu_torch/utils/logger.py`).  Spans and counters
record only while a profiler runs, so in a run they are those of the
traced stretch; builds are the whole process's.  A program without the
recorder gives None, and the metrics that read it are left out."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional


def recorded() -> Optional[Dict]:
    try:
        from lanemapping_tpu_torch.utils.logger import recorded as snapshot
    except ImportError:
        return None
    return snapshot()


def offcpu_pct(names: Iterable[str]) -> Optional[float]:
    """100 x (1 - their threads' CPU time / their wall time), summed over
    the spans of these names: the share of the spans' time their threads
    were off the CPU (waiting for the interpreter lock, the card or I/O)."""
    r = recorded()
    if r is None:
        return None
    names = set(names)
    sel = [s for s in r["spans"] if s["name"] in names]
    wall = sum(s["end_ns"] - s["start_ns"] for s in sel)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - sum(s["cpu_ns"] for s in sel) / wall)


def counters() -> Optional[Dict[str, int]]:
    """The counters, if the post-process counted any tile."""
    r = recorded()
    if r is None or not r["counters"].get("tiles"):
        return None
    return r["counters"]


def train_steps() -> Optional[List[Dict]]:
    """The training steps: each ``train.step`` span with ``phases``, its
    phase spans (``train.buffers`` ... ``train.optimizer``) by name; a
    step without its ``train.guard`` is left out."""
    r = recorded()
    if r is None:
        return None
    steps = {s["id"]: dict(s, phases={}) for s in r["spans"]
             if s["name"] == "train.step"}
    for s in r["spans"]:
        if s["parent"] in steps:
            steps[s["parent"]]["phases"][s["name"]] = s
    out = [st for st in steps.values() if "train.guard" in st["phases"]]
    return out or None


def wall_ms(span: Dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e6


def build_seconds() -> Optional[float]:
    """Seconds of the process spent building libraries (nvcc, g++): the
    union of the builds' intervals, 0 when none was built."""
    r = recorded()
    if r is None:
        return None
    total, end = 0.0, None
    for b in sorted(r["builds"], key=lambda b: b["start"]):
        if end is None or b["start"] > end:
            total += b["end"] - b["start"]
            end = b["end"]
        elif b["end"] > end:
            total += b["end"] - end
            end = b["end"]
    return total
