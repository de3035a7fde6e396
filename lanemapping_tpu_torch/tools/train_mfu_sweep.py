"""Train-step MFU sweep (port of the root `tools/train_mfu_sweep.py`).

Sweeps batch size x remat policy (``none``, ``full``, ``dots``) through
``python -m lanemapping_tpu_torch.tools.bench --train`` on the card, one
child process a cell, and writes the table: s/step, train MFU against the
card's dense bf16 peak, train tiles/s, the step's model FLOPs and peak
memory.  A cell that fails (out of memory at a large batch without remat)
is recorded with the tail of its errors and the sweep goes on.  Its cells
also serve `tools/batch_ceiling.py`, which runs ``bench`` serving through
them (no remat policy) as well.

    python -m lanemapping_tpu_torch.tools.train_mfu_sweep \\
        [--batches 4 8 16] [--policies full dots] [--also-none-at 4] \\
        [--iters 4] [--sets "k=v;k=v"] [--log-dir DIR] [--device cuda]

Each child builds the kernels and runs cuDNN's autotune in its warm-up
step; the cell's s/step is the child's own (CUDA events after that step),
``wall_s`` the whole child.  The record goes to
``<log-dir>/train_mfu_sweep.json`` unless ``--out`` names a file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OOM_MARKERS = ("CUDA out of memory", "OutOfMemoryError")


def bench_cmd(batch: int, remat: Optional[str], iters: Optional[int],
              sets: str = "", device: str = "cuda",
              config: Optional[str] = None, extra: Sequence[str] = ()) -> list:
    """The ``bench`` command of one cell: ``--train`` under the remat policy
    ``remat`` (``none``, ``full``, ``dots``), or serving where ``remat`` is
    None; ``iters`` None keeps bench's own; ``extra`` further bench flags."""
    cmd = [sys.executable, "-m", "lanemapping_tpu_torch.tools.bench"]
    cmd += ["--train"] if remat is not None else []
    cmd += ["--batch", str(batch)]
    cmd += ["--iters", str(iters)] if iters is not None else []
    cmd += ["--device", device]
    if remat is not None:
        cmd += ["--no-remat"] if remat == "none" else [
            "--remat", "--remat-policy", remat]
    if sets:
        cmd += ["--set", sets]
    if config:
        cmd += ["--config", config]
    return cmd + list(extra)


def parse_cell(batch: int, remat: Optional[str], returncode: int,
               stdout: str, stderr: str, wall_s: float,
               sets: str = "") -> Dict:
    """A sweep cell from a ``bench`` child's exit code and output: its
    record's figures (serving's tiles/s, peak and digest; the training
    step's s/step, MFU, tiles/s, FLOPs and peak), or the tail of its errors,
    and whether they are an out-of-memory error (``oom``), when it failed
    or printed no JSON record."""
    cell = {"batch": batch, "remat_policy": remat, "wall_s": wall_s}
    if sets:
        cell["set"] = sets
    rec = None
    for line in stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                pass
    if returncode != 0 or rec is None:
        cell["error"] = (stderr or stdout)[-1500:]
        cell["rc"] = returncode
        cell["oom"] = any(m in stderr + stdout for m in OOM_MARKERS)
        return cell
    if rec.get("unit") == "tiles/s":
        cell.update({"tiles_per_sec": rec["value"],
                     "ms_per_pass": rec.get("ms_per_pass"),
                     "digest_mean": rec.get("digest_mean"),
                     "hbm_highwater_gb": rec.get("hbm_highwater_gb")})
        return cell
    cell.update({
        "sec_per_step": rec["value"],
        "train_mfu": rec.get("train_mfu"),
        "tiles_per_sec_train": rec.get("tiles_per_sec_train"),
        "step_flops": rec.get("step_flops"),
        "hbm_highwater_gb": rec.get("hbm_highwater_gb"),
    })
    return cell


def run_cell(batch: int, remat: Optional[str], iters: Optional[int],
             sets: str = "", device: str = "cuda",
             config: Optional[str] = None, timeout: int = 3600,
             extra: Sequence[str] = ()) -> Dict:
    """One cell in a child process run from the repository's root."""
    t0 = time.perf_counter()
    p = subprocess.run(bench_cmd(batch, remat, iters, sets, device, config,
                                 extra),
                       cwd=REPO, capture_output=True, text=True,
                       timeout=timeout)
    return parse_cell(batch, remat, p.returncode, p.stdout, p.stderr,
                      time.perf_counter() - t0, sets)


def best_cells(cells) -> Dict:
    """``best_mfu`` and ``best_tiles_per_sec`` among the cells that ran;
    empty when none did."""
    ok = [c for c in cells if "sec_per_step" in c]
    if not ok:
        return {}
    return {"best_mfu": max(ok, key=lambda c: c.get("train_mfu") or 0.0),
            "best_tiles_per_sec": max(
                ok, key=lambda c: c.get("tiles_per_sec_train") or 0.0)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[4, 8, 16])
    ap.add_argument("--policies", nargs="+", default=["full", "dots"],
                    choices=("none", "full", "dots"))
    ap.add_argument("--also-none-at", type=int, default=4,
                    help="additionally run remat=none at this batch "
                         "(0 to skip)")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--sets", default="",
                    help="semicolon-separated cfg overrides applied to every "
                         "cell through bench --set (e.g. 's2d_stem=True')")
    ap.add_argument("--config", default=None,
                    help="config of every cell (default bench's flagship)")
    ap.add_argument("--log-dir", default="train_mfu_sweep_logs")
    ap.add_argument("--out", default=None,
                    help="record path (default <log-dir>/train_mfu_sweep.json)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    from ..api import resolve_device
    from .soak_run import card_provenance

    args = parse_args(argv)
    device = resolve_device(args.device)
    out = args.out or os.path.join(args.log_dir, "train_mfu_sweep.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    record = {"metric": "train_sec_per_step_sweep", "img": 1152,
              "dtype": "bfloat16", "date": time.strftime("%Y-%m-%d"),
              **card_provenance(device), "cells": []}
    cells = [(b, pol) for b in args.batches for pol in args.policies]
    if args.also_none_at and (args.also_none_at, "none") not in cells:
        cells.append((args.also_none_at, "none"))
    for b, pol in cells:
        print(f"[mfu_sweep] batch={b} remat={pol} ...", flush=True)
        cell = run_cell(b, pol, args.iters, args.sets, args.device,
                        args.config)
        record["cells"].append(cell)
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
        print(json.dumps(cell)[:800], flush=True)
    record.update(best_cells(record["cells"]))
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    if "best_mfu" in record:
        print("[mfu_sweep] best MFU:", json.dumps(record["best_mfu"]))
    return record


if __name__ == "__main__":
    main()
