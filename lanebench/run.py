"""Run one cell of the benchmark of lanemapping_tpu_torch on one card.

    python3 lanebench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell (``workloads`` in BENCHMARK.json)
names a configuration (`lanebench/configs/<name>.json`) and a traffic mix
(`lanebench/traffic/<name>.json`), whose ``loop``
(`lanebench/loops/<loop>.py`) draws the inputs and the weights from
``--seed`` (a served model's weights from the configuration's ``seed``),
warms up, measures for ``--seconds`` and checks what the timed
path produced against the plain reference (`lanebench/plain`).  With
``--trace 0`` the result line carries the cell's end-to-end metrics; with
``--trace 1`` a stretch after the window is traced and the line carries
its per-layer metrics, each read by `lanebench/metrics/<name>.py`.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), then ``checks``, each compared number with its limit.  A
run with no card (or fewer than the cell asks for), or that finds JAX or
the JAX package loaded once the window has closed, prints no result and
exits with another code than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lanebench import core  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def metrics_of(rec: core.Run) -> dict:
    """The cell's end-to-end metrics (``--trace 0``) or its per-layer
    metrics (``--trace 1``) that have a reading."""
    cell = rec.cell
    out = {}
    if not rec.tracing:
        values = dict(rec.e2e)
        values["setup_s"] = rec.notes["setup_s"]
        values["peak_gib"] = rec.memory_peak_bytes / 2 ** 30
        for m in cell.end_to_end:
            if m["name"] in values:
                out[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        v = core.reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = core.Cell(args.workload)
    torch = core.require_cards(cell.chips)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # the card, its power limit and the host's cores, on an earlier line
    print(f"[lanebench] card: {core.card_line()}; host cpus: "
          f"{os.cpu_count()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    rec = core.Run(cell, args.seconds, bool(args.trace))
    rec.device_kind = torch.cuda.get_device_name(device)
    core.loop(cell).run(cell, rec, args.seed, args.seconds, device,
                        T_START)
    device_info = {"platform": "gpu", "kind": rec.device_kind,
                   "count": cell.chips,
                   "memory_peak_bytes": int(rec.memory_peak_bytes)}
    breakdown = None
    if rec.tracing:
        if rec.trace is None or rec.trace.busy_s <= 0:
            core.log("the trace holds no device activity")
            return 5
        device_info["busy_s"] = rec.trace.busy_s
        device_info["window_s"] = rec.trace.window_s
        breakdown = rec.trace.breakdown()
    if rec.trace is not None:
        rec.notes["trace_reduce_s"] = rec.trace.reduce_s
    rec.notes["wall_s"] = time.perf_counter() - T_START
    core.log(f"notes: {rec.notes}; launches {rec.launches}")
    bad = core.forbidden_modules(list(sys.modules))
    if bad:
        core.log(f"JAX or the JAX package was loaded: {bad}")
        return 4
    core.emit(rec, metrics_of(rec), device_info, breakdown)
    return 0


if __name__ == "__main__":
    sys.exit(main())
