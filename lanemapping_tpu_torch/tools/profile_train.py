"""Profile the full-size training step and attribute device time by kernel
(port of the root `tools/profile_train.py`).

    python -m lanemapping_tpu_torch.tools.profile_train [--batch 8] \\
        [--steps 3] [--log-dir DIR] [--device cuda]
    python -m lanemapping_tpu_torch.tools.profile_train --parse-only \\
        --trace DIR/trace.json

Builds the step of ``bench --train`` (`tools/bench.py::build_train`: the
flagship at its shipping defaults, bf16, batch resident on the card), runs
one warm-up step, then ``--steps`` steps under ``torch.profiler`` (CPU and
CUDA activity), and writes the Chrome trace (``export_chrome_trace``).
`device_time_by_kernel` reads that trace: the device time of every kernel,
copy and memset, summed by kernel name and by category (``CATEGORIES``,
pattern rules on the names that stand in for XLA's ``hlo_category``), and
the device's busy share of the traced window (the union of the device
intervals over the span of all the trace's events).

The record also holds the host milliseconds a step of each of the step's
phases (``host_ms_per_step``: the wall time of the ``train.*`` spans that
`engine/state.py::make_train_step` records while the profiler runs, over
the profiled steps; not on ``--parse-only``).

``torch.profiler`` gives no bytes per kernel, so the root script's
``gb_per_s`` and ``hbm_bw_util`` have no counterpart here and are not
estimated.  The record goes to ``<log-dir>/profile_train.json`` unless
``--out`` names a file; ``--parse-only`` rebuilds it from a saved trace.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# (category, pattern on the kernel name), first match wins; copies and
# memsets are "copy_cast" by their trace category as well
CATEGORIES = (
    ("nccl", r"nccl"),
    ("port_kernels", r"band_(hist|scan|scatter)_kernel|bev_mean_kernel"
                     r"|voxel_mean_kernel"),
    ("copy_cast", r"copy|memcpy|memset|nchwToNhwc|nhwcToNchw|transpose"
                  r"|permute|CatArray"),
    ("reduction", r"reduce|welford|batch_norm|bn_fw|bn_bw|norm|softmax"
                  r"|var_mean|argmax|topk|sort"),
    ("convolution", r"conv|fprop|dgrad|wgrad|implicit_gemm|winograd"),
    ("gemm", r"gemm|gemv|nvjet|cutlass|cublas|matmul|xmma"),
    ("elementwise", r"elementwise|vectorized|pointwise|fill|index|gather"
                    r"|scatter|upsample|where"),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NOT_MEASURED = ("gb_per_s and hbm_bw_util: torch.profiler records no bytes "
                "per kernel, so no achieved memory rate is given")


def category(name: str, trace_cat: str = "kernel") -> str:
    """The category of a device event by ``CATEGORIES``; "other" if no
    rule matches."""
    if trace_cat in ("gpu_memcpy", "gpu_memset"):
        return "copy_cast"
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name, flags=re.IGNORECASE):
            return cat
    return "other"


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_time_by_kernel(trace: Dict, top_n: int = 20) -> Dict:
    """Aggregate a ``torch.profiler`` Chrome trace's device events
    (``cat`` kernel, gpu_memcpy, gpu_memset): ``top_ops`` (the ``top_n``
    names with the most device time: total us, calls, pct of the device
    total), ``by_category`` (every category, the same columns),
    ``device_total_us`` (the sum of the events' durations),
    ``device_busy_us`` (the union of their intervals, so overlapping
    kernels count once), ``traced_window_us`` (first start to last end of
    all complete events, host ones included) and ``device_busy_share``."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    by_name = defaultdict(lambda: [0.0, 0])
    by_cat = defaultdict(lambda: [0.0, 0])
    for e in dev:
        us = float(e["dur"])
        for table, key in ((by_name, e["name"]),
                           (by_cat, category(e["name"], e["cat"]))):
            table[key][0] += us
            table[key][1] += 1
    total = sum(v[0] for v in by_name.values())

    def rows(table, top=None):
        items = sorted(table.items(), key=lambda kv: -kv[1][0])[:top]
        return [{"name": n[:160], "total_us": round(us, 3), "calls": c,
                 "pct": 100.0 * us / total if total else 0.0}
                for n, (us, c) in items]

    busy = union_us([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in dev])
    window = (max(float(e["ts"]) + float(e["dur"]) for e in events)
              - min(float(e["ts"]) for e in events)) if events else 0.0
    return {"top_ops": rows(by_name, top_n), "by_category": rows(by_cat),
            "device_total_us": total, "device_busy_us": busy,
            "traced_window_us": window,
            "device_busy_share": busy / window if window else None}


def phase_ms_per_step(spans: List[Dict], steps: int) -> Dict[str, float]:
    """Host milliseconds a step of each ``train.*`` phase among the
    recorder's ``spans``, over ``steps`` steps."""
    out: Dict[str, float] = {}
    for s in spans:
        if s["name"].startswith("train."):
            out[s["name"]] = out.get(s["name"], 0.0) + (
                s["end_ns"] - s["start_ns"]) / 1e6 / max(steps, 1)
    return out


def profile_steps(step, state, batch, steps: int, trace_path: str
                  ) -> Dict[str, float]:
    """``steps`` training steps under ``torch.profiler``, the card drained
    inside the session, the trace written to ``trace_path``; profiled once
    more if the trace holds no device event (a second profiler session of
    one process on the card has handed back such a trace).  Returns the
    host milliseconds a step of each phase (`phase_ms_per_step`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from ..utils.logger import recorded, reset_recorder

    for attempt in range(2):
        reset_recorder()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                stats = step(state, batch)
            torch.cuda.synchronize()
        prof.export_chrome_trace(trace_path)
        if not math.isfinite(float(stats["loss"])) or stats["skipped_nan"]:
            raise RuntimeError(f"[profile] non-finite loss {stats}")
        with open(trace_path) as f:
            trace = json.load(f)
        if any(e.get("cat") in DEVICE_CATS
               for e in trace.get("traceEvents", [])):
            return phase_ms_per_step(recorded()["spans"], steps)
        print("[profile] the trace holds no device event; profiling again",
              flush=True)
    raise RuntimeError("[profile] torch.profiler recorded no device event")


def write_record(args, provenance: Dict,
                 host_ms: Optional[Dict[str, float]] = None) -> Dict:
    with open(args.trace) as f:
        agg = device_time_by_kernel(json.load(f))
    record = {
        "metric": "train_step_device_time_by_op",
        "batch": args.batch,
        "steps_traced": args.steps,
        "device_total_us": agg["device_total_us"],
        "per_step_ms": agg["device_total_us"] / 1e3 / max(args.steps, 1),
        "device_busy_us": agg["device_busy_us"],
        "traced_window_us": agg["traced_window_us"],
        "device_busy_share": agg["device_busy_share"],
        "by_category": agg["by_category"],
        "top_ops": agg["top_ops"],
        **({"host_ms_per_step": host_ms} if host_ms is not None else {}),
        "not_measured": NOT_MEASURED,
        "trace": os.path.abspath(args.trace),
        **provenance,
        "provenance": "lanemapping_tpu_torch/tools/profile_train.py: "
                      f"torch.profiler over {args.steps} steps of the "
                      "bench --train step (the config's shipping defaults, "
                      f"bf16, batch {args.batch}) after one warm-up step; "
                      "device events (kernels, copies, memsets) of the "
                      "Chrome trace by name and by pattern category. "
                      + time.strftime("%Y-%m-%d"),
    }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[profile] device {record['per_step_ms']:.3f} ms/step, busy "
          f"share {record['device_busy_share']}")
    for c in record["by_category"]:
        print(f"  cat {c['pct']:6.2f}%  {c['name']}")
    for o in record["top_ops"][:10]:
        print(f"{o['pct']:6.2f}%  {o['name'][:100]}")
    for name, ms in (host_ms or {}).items():
        print(f"  host {ms:8.3f} ms/step  {name}")
    print(f"[profile] wrote {args.out}", flush=True)
    return record


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--log-dir", default="train_profile_logs")
    ap.add_argument("--trace", default=None,
                    help="Chrome trace path (default <log-dir>/trace.json)")
    ap.add_argument("--out", default=None,
                    help="record path (default <log-dir>/profile_train.json)")
    ap.add_argument("--parse-only", action="store_true",
                    help="re-read an existing trace without running")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.trace = args.trace or os.path.join(args.log_dir, "trace.json")
    args.out = args.out or os.path.join(args.log_dir, "profile_train.json")
    return args


def main(argv=None) -> Dict:
    args = parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if args.parse_only:
        return write_record(args, {})

    import torch

    from ..api import resolve_device
    from ..config.config import Config
    from .bench import FLAGSHIP, build_train
    from .soak_run import card_provenance

    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("[profile] profile_train reads the card's kernels "
                         "from the trace: it needs --device cuda "
                         "(--parse-only re-reads a saved trace anywhere)")
    cfg = Config.fromfile(FLAGSHIP)
    cfg.batch_size = args.batch
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    state, step, batch = build_train(cfg, args.batch, device)
    t0 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    print(f"[profile] first step {time.perf_counter() - t0:.1f} s",
          flush=True)
    host_ms = profile_steps(step, state, batch, args.steps, args.trace)
    return write_record(args, card_provenance(device), host_ms)


if __name__ == "__main__":
    main()
