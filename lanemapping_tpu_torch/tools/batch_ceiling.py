"""The largest batch the card takes: `tools/bench.py` serving (or
``--train``) in one child process a batch, batches in the given order
until one fails, then halving the gap between the largest batch that ran
and the smallest that failed until they are ``--resolution`` apart.

    python -m lanemapping_tpu_torch.tools.batch_ceiling \\
        [--batches 102 128 160 192 224 256] [--resolution 1] \\
        [--train [full|dots|none]] [--config PATH] \\
        [--bench-args "--iters 2 --lidar-points 524288"] [--out FILE] \\
        [--device cuda]

The cells are `tools/train_mfu_sweep.py`'s (``run_cell``): the bench
record's figures (tiles/s, peak GiB and digest serving; s/step, MFU and
peak GiB training) or, for a batch that failed, its exit code, the tail of
its errors and whether they are an out-of-memory error (``oom``) or a
refusal of another kind, such as an element-count limit.  The record
names the ceiling (the largest batch that ran), the first batch that
failed and the message that set the ceiling, with the card's name and
power limit.  It prints one JSON line and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
from typing import Callable, Dict, List

from .train_mfu_sweep import run_cell

CELL_TIMEOUT_S = 1200  # a bench child at the card's largest batches: < 60 s


def error_line(text: str) -> str:
    """The last line of ``text`` that names an error (a traceback's
    last), else its last line."""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    errs = [ln for ln in lines if "Error" in ln or "error" in ln]
    return (errs or lines or [""])[-1][:600]


def find_ceiling(batches: List[int], run: Callable[[int], Dict],
                 resolution: int = 1) -> Dict:
    """Runs ``run(batch)`` over ``batches`` in order until a cell fails
    (has an ``error``), then bisects between the largest batch that ran and
    the failed one until they are ``resolution`` apart.
    Returns {"cells", "ceiling", "first_failed", "set_by"}; ``ceiling``
    is None when no batch ran, ``first_failed`` None when none failed."""
    cells, ok, bad = [], None, None
    for b in batches:
        cell = run(b)
        cells.append(cell)
        if "error" in cell:
            bad = cell
            break
        ok = cell
    if bad is not None and ok is not None:
        while bad["batch"] - ok["batch"] > max(resolution, 1):
            cell = run((ok["batch"] + bad["batch"]) // 2)
            cells.append(cell)
            if "error" in cell:
                bad = cell
            else:
                ok = cell
    return {"cells": cells, "ceiling": ok["batch"] if ok else None,
            "first_failed": bad["batch"] if bad else None,
            "set_by": (("out of memory: " if bad["oom"] else "refused: ")
                       + error_line(bad["error"])) if bad else None}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[102, 128, 160, 192, 224, 256])
    ap.add_argument("--resolution", type=int, default=1,
                    help="stop bisecting when the gap is this many tiles")
    ap.add_argument("--train", nargs="?", const="full", default=None,
                    choices=("full", "dots", "none"),
                    help="bench --train under this remat policy (full "
                         "when none is named) instead of serving")
    ap.add_argument("--config", default=None,
                    help="config of every cell (default bench's flagship)")
    ap.add_argument("--bench-args", default="",
                    help='further bench flags, e.g. "--iters 2 '
                         '--lidar-points 524288"')
    ap.add_argument("--out", default=None, help="also write the record here")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    from ..api import resolve_device
    from .soak_run import card_provenance

    args = parse_args(argv)
    device = resolve_device(args.device)

    def run(batch: int) -> Dict:
        print(f"[batch_ceiling] batch {batch} ...", flush=True)
        cell = run_cell(batch, args.train, None, device=args.device,
                        config=args.config, timeout=CELL_TIMEOUT_S,
                        extra=shlex.split(args.bench_args))
        print(json.dumps(cell)[:800], flush=True)
        return cell

    record = {"metric": "batch_ceiling",
              "mode": "serving" if args.train is None else "train",
              "remat_policy": args.train,
              "config": args.config or "flagship (bench default)",
              "bench_args": args.bench_args, **card_provenance(device),
              "resolution": args.resolution,
              **find_ceiling(args.batches, run, args.resolution)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
