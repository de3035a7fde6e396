"""What every cell shares: the manifest, the device, the spans, the trace,
the check that no JAX was loaded, and the result line."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded in a run (compared whole:
# the program, lanemapping_tpu_torch, begins with the JAX package's name)
FORBIDDEN = ("jax", "jaxlib", "flax", "lanemapping_tpu")
PEAKS = os.path.join(HERE, "peaks.json")


def log(*a) -> None:
    print("[lanebench]", *a, file=sys.stderr, flush=True)


# -- the manifest -------------------------------------------------------------

class Cell:
    """One workload of BENCHMARK.json with its configuration, its traffic
    mix and its metrics, each found by name."""

    def __init__(self, name: str, manifest_path: Optional[str] = None):
        path = manifest_path or os.path.join(ROOT, "BENCHMARK.json")
        with open(path) as f:
            m = json.load(f)
        by_name = {w["name"]: w for w in m["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in {path}")
        self.workload = by_name[name]
        self.name = name
        conf = {c["name"]: c for c in m["configs"]}[self.workload["config"]]
        self.config_entry = conf
        with open(os.path.join(ROOT, conf["file"])) as f:
            self.config = json.load(f)
        self.traffic_name = self.workload["traffic"]
        with open(os.path.join(HERE, "traffic",
                               self.traffic_name + ".json")) as f:
            self.traffic = json.load(f)
        self.end_to_end = [e for e in m["end_to_end"]
                           if name in e.get("workloads", [name])]
        self.per_layer = [e for e in m["per_layer"]
                          if name in e.get("workloads", [name])]
        self.chips = int(self.workload["chips"])
        # the limits of the numbers the check compares, set from readings
        # (PERF.md): `lanebench/limits/<cell>.json`
        with open(os.path.join(HERE, "limits", name + ".json")) as f:
            self.limits = json.load(f)


def load_file_module(path: str, name: str):
    """A module from a file whose name may hold dots."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop(cell: Cell):
    """The traffic mix's loop, `lanebench/loops/<loop>.py`."""
    return load_file_module(
        os.path.join(HERE, "loops", cell.traffic["loop"] + ".py"),
        "lanebench_loop_" + cell.traffic["loop"])


def reader(metric: str) -> Callable:
    """The per-layer metric's reader, `lanebench/metrics/<name>.py`."""
    mod = load_file_module(os.path.join(HERE, "metrics", metric + ".py"),
                           "lanebench_metric_" + metric.replace(".", "_"))
    return mod.read


def peaks(kind: str) -> Dict[str, float]:
    with open(PEAKS) as f:
        table = json.load(f)
    if kind not in table:
        raise KeyError(f"no published peaks for {kind!r} in {PEAKS}")
    return table[kind]


# -- the device ----------------------------------------------------------------

def require_cards(n: int):
    """The torch module, once a card is there: no card, or fewer than the
    cell asks for, ends the run without a result."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        log(f"needs {n} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        sys.exit(3)
    return torch


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({type(e).__name__})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def forbidden_modules(names: Sequence[str]) -> List[str]:
    """The loaded modules whose top-level name is a forbidden one, compared
    whole."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


# -- spans ---------------------------------------------------------------------

class Spans:
    """Per-layer time of the window: host milliseconds, and CUDA event
    pairs read once the window has closed."""

    def __init__(self):
        self.host: Dict[str, List[float]] = {}
        self.events: Dict[str, List[tuple]] = {}

    def add_host(self, name: str, ms: float) -> None:
        self.host.setdefault(name, []).append(ms)

    def add_events(self, name: str, a, b) -> None:
        self.events.setdefault(name, []).append((a, b))

    def ms(self, name: str) -> List[float]:
        if name in self.host:
            return self.host[name]
        return [a.elapsed_time(b) if hasattr(a, "elapsed_time")
                else (b - a) * 1e3 for a, b in self.events.get(name, [])]

    def mean_ms(self, name: str) -> Optional[float]:
        v = self.ms(name)
        return float(np.mean(v)) if v else None


# -- the trace -----------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_MARK = "lanebench.window"


class Trace:
    """A profiler trace of a stretch of the window, reduced: the device's
    busy seconds in the stretch (the union of kernels, copies and sets), its
    length, the device time by operation name and the longest idle gaps by
    what the host was doing."""

    def __init__(self, path: str):
        with open(path) as f:
            raw = json.load(f)
        ev = raw["traceEvents"] if isinstance(raw, dict) else raw
        marks = [e for e in ev if e.get("name") == WINDOW_MARK
                 and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"]
        if not marks:
            raise RuntimeError("the trace holds no window mark")
        t0 = min(float(e["ts"]) for e in marks)
        t1 = max(float(e["ts"]) + float(e["dur"]) for e in marks)
        self.window_s = (t1 - t0) / 1e6
        dev = []
        for e in ev:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            a, b = max(a, t0), min(b, t1)
            if b > a:
                dev.append((a, b, e.get("name", "?")))
        dev.sort()
        self.kernels: Dict[str, List[float]] = {}
        for a, b, n in dev:
            self.kernels.setdefault(n, []).append((b - a) / 1e6)
        merged: List[List[float]] = []
        for a, b, _ in dev:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        edges = [t0] + [x for ab in merged for x in ab] + [t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["cat"] == "user_annotation", e["name"]) for e in ev
                      if e.get("ph") == "X"
                      and e.get("cat") in ("user_annotation", "cpu_op")
                      and e.get("name") != WINDOW_MARK)
        by_gap: Dict[str, float] = {}
        active: List[tuple] = []
        j = 0
        for a, b in gaps:  # a sweep: gaps and host events by start
            while j < len(host) and host[j][0] < b:
                active.append(host[j])
                j += 1
            active = [h for h in active if h[1] > a]
            name = self._host_at(active, a, b)
            by_gap[name] = by_gap.get(name, 0.0) + (b - a) / 1e6
        self.idle_gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]

    @staticmethod
    def _host_at(active, a, b) -> str:
        """What the host was doing over the idle stretch [a, b]: the
        innermost operator that covers at least half of it, else the
        benchmark's span there (the host ran no operator: it waited, or ran
        Python between operators)."""
        op = span = None
        for s, t, ours, name in active:
            r = (min(t, b) - max(s, a), s, name)
            if r[0] <= 0:
                continue
            if ours:
                span = max(span, r) if span else r
            else:
                op = max(op, r) if op else r
        if op and op[0] >= 0.5 * (b - a):
            return op[2]
        if span:
            return span[2]
        return op[2] if op else "host: no recorded activity"

    def time_of(self, pattern: Callable[[str], bool]) -> tuple:
        """(seconds, count) of the device operations whose name matches."""
        t = n = 0
        for name, durs in self.kernels.items():
            if pattern(name):
                t += sum(durs)
                n += len(durs)
        return t, n

    def breakdown(self) -> Dict:
        ops = sorted(((n, sum(d)) for n, d in self.kernels.items()),
                     key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[n[:200], s] for n, s in self.idle_gaps]}


class Profiler:
    """torch.profiler over a stretch of the window (``--trace 1``); the
    stretch is marked so that the reduction reads only it."""

    def __init__(self, enabled: bool, out_dir: str):
        self.enabled = enabled
        self.path = os.path.join(out_dir, "lanebench_trace.json")
        self.prof = None
        self.mark = None
        self.trace: Optional[Trace] = None

    def start(self):
        if not self.enabled or self.prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.mark = record_function(WINDOW_MARK)
        self.mark.__enter__()
        self._torch = torch

    def span(self, name: str):
        """A named host span in the trace (no-op when not tracing)."""
        import contextlib
        if self.prof is None or self.mark is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def stop(self):
        if self.prof is None or self.mark is None:
            return
        self._torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.mark = None
        self.prof.__exit__(None, None, None)

    def reduce(self) -> Optional[Trace]:
        if self.prof is None:
            return None
        t = time.perf_counter()
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        try:
            self.trace = Trace(self.path)
        finally:
            os.remove(self.path)
        self.trace.reduce_s = time.perf_counter() - t
        return self.trace


# -- the result ----------------------------------------------------------------

class Run:
    """What a loop hands back and the readers read."""

    def __init__(self, cell: Cell, seconds: float, trace: bool):
        self.cell = cell
        self.seconds = seconds
        self.tracing = trace
        self.spans = Spans()
        self.trace: Optional[Trace] = None
        self.attempted = 0
        self.failed = 0
        self.e2e: Dict[str, float] = {}
        self.window_s = None
        self.units = 0             # tiles served or steps taken in the window
        self.unit_flops = None     # FLOPs a tile (serving) or a step
        self.kernel_bytes: Dict[str, float] = {}  # bytes a launch by kernel
        self.launches: Dict[str, int] = {}
        self.checks: List[tuple] = []   # (name, value, limit)
        self.memory_peak_bytes = 0
        self.notes: Dict = {}

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return within(self.checks)


def within(checks: Sequence[tuple]) -> bool:
    """The rule of ``correct``: some number was compared, and each
    (name, value, limit) is finite and at most its limit."""
    return bool(checks) and all(np.isfinite(v) and v <= lim
                                for _, v, lim in checks)


def emit(run: Run, metrics: Dict[str, Dict], device: Dict,
         breakdown: Optional[Dict]) -> None:
    """The compared numbers on standard error, then the result line."""
    for name, v, lim in run.checks:
        log(f"check {name}: {v!r} limit {lim!r} "
            f"{'ok' if v <= lim else 'FAILED'}")
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    print(json.dumps(out), flush=True)


def now() -> float:
    return time.perf_counter()
