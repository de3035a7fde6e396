"""Endpoint-decode sweep on a trained checkpoint (port of the root
`tools/endp_sweep.py`).

Knobs:

  on the card (the endpoint decode, re-run on each batch's heatmap):
    * endp_score_thre: drop top-K candidates scored below it before
      clustering (0.0 = reference: every noise candidate forms a
      false-positive cluster representative)
    * endp_cluster_r: single-linkage cluster radius (reference: 20)
  on the host:
    * endp_keep_line_ends: exempt a line's terminal zone from the
      interior-endpoint prune (the reference deletes its own line ends,
      `polyline_utils.py:530-536`)
    * ref_exact_occupancy_filter: the reference's single-row occupancy bug

Three stages as in the JAX script: the reference-equivalent baseline and a
score-threshold sweep at radius 20; the radii at the best threshold; the
host knobs at the best device settings.  A cell decodes everything as
``Runner._eval_decode`` does, then re-decodes the endpoints with the
cell's threshold and radius (`decode/lane_decode.py::decode_endpoints`,
which takes both as Python floats, so no compiled program is shared as in
the JAX script).  The record holds every cell's metrics and wall, the
best cell and the recommended defaults.

    python -m lanemapping_tpu_torch.tools.endp_sweep --data-root <root> \\
        --ckpt <log_dir>/ckpt/best [--device cuda]

It writes ``<log-dir>/endp_sweep.json`` unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .soak_run import FLAGSHIP, card_provenance


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=FLAGSHIP)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--log-dir", default="endp_sweep_logs")
    ap.add_argument("--out", default=None,
                    help="record path (default <log-dir>/endp_sweep.json)")
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--thres", type=float, nargs="+",
                    default=[0.0, 0.08, 0.3, 0.5])
    ap.add_argument("--radii", type=float, nargs="+", default=[10.0, 30.0])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def sweep_decode(runner, thre: float, radius: float):
    """``Runner._eval_decode`` with the endpoints decoded at score
    threshold ``thre`` and cluster radius ``radius``, both rounded to
    float32 as the JAX script feeds them."""
    from ..decode.lane_decode import (decode_endpoints, decode_lanes,
                                      host_decode_view)
    from ..engine.state import eval_step

    cfg = runner.cfg
    endp_key = "endpoint" if cfg.heads.get("endp_mode", "endp_est") == \
        "endpoint" else "endp_est"
    thre, radius = float(np.float32(thre)), float(np.float32(radius))

    def decode(out):
        dec = decode_lanes(out, cfg)
        dec["endp_coords"], dec["endp_valid"] = decode_endpoints(
            out[endp_key][..., 0], num_cls=cfg.number_lanes, radius=radius,
            score_thre=thre)
        return host_decode_view(dec)

    return lambda batch: eval_step(runner.model, runner._eval_input(batch),
                                   decode)


def main(argv=None) -> dict:
    from ..api import resolve_device
    from ..config.config import Config
    from ..engine.checkpoint import load_model
    from ..engine.runner import Runner

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    cfg.batch_size = args.batch
    cfg.gt_cache = True
    for s in ("train", "val", "test"):
        cfg.dataset[s]["data_root"] = args.data_root
    out = args.out or os.path.join(args.log_dir, "endp_sweep.json")
    runner = Runner(cfg, log_dir=args.log_dir, device=device)
    load_model(os.path.abspath(args.ckpt), runner.state, cfg.get("seed", 0))
    runner.best_metric = float("inf")  # a sweep never saves "best"

    record = {"ckpt": os.path.abspath(args.ckpt),
              "data_root": args.data_root, **card_provenance(device),
              "date": time.strftime("%Y-%m-%d"), "cells": []}

    def run_cell(thre, radius, keep_ends, occ_bug, label):
        runner.cfg.endp_keep_line_ends = keep_ends
        runner.cfg.ref_exact_occupancy_filter = occ_bug
        runner._eval_decode = sweep_decode(runner, thre, radius)
        t0 = time.time()
        m = runner.validate(max_batches=args.max_batches)
        cell = {"label": label, "endp_score_thre": thre,
                "endp_cluster_r": radius, "endp_keep_line_ends": keep_ends,
                "ref_exact_occupancy_filter": occ_bug,
                **{k: round(float(v), 4) for k, v in m.items()},
                "wall_s": time.time() - t0}
        record["cells"].append(cell)
        _save(out, record)
        print(json.dumps(cell), flush=True)
        return cell

    # stage 1: reference-equivalent baseline, then the threshold sweep
    base = run_cell(0.0, 20.0, False, False, "baseline(ref-equivalent)")
    best = base
    for thre in args.thres:
        if thre == 0.0:
            continue
        c = run_cell(thre, 20.0, False, False, f"thre={thre}")
        if c["endp_f1"] > best["endp_f1"]:
            best = c

    # stage 2: cluster radius at the best threshold
    for radius in args.radii:
        c = run_cell(best["endp_score_thre"], radius, False, False,
                     f"radius={radius}")
        if c["endp_f1"] > best["endp_f1"]:
            best = c

    # stage 3: host knobs at the best device settings
    bt, br = best["endp_score_thre"], best["endp_cluster_r"]
    for keep_ends, occ in ((True, False), (False, True), (True, True)):
        c = run_cell(bt, br, keep_ends, occ,
                     f"keep_ends={keep_ends},occ_bug={occ}")
        if c["endp_f1"] > best["endp_f1"]:
            best = c

    record["best"] = best
    record["recommended_defaults"] = {
        "endp_score_thre": best["endp_score_thre"],
        "endp_cluster_r": best["endp_cluster_r"],
        "endp_keep_line_ends": best["endp_keep_line_ends"],
    }
    _save(out, record)
    print("[endp_sweep] best:", json.dumps(best))
    return record


def _save(path, record):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
