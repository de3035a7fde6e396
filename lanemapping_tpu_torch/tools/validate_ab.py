"""The pipelined validation loop against the serial one (port of the root
`tools/validate_ab.py`).

`Runner._validate_lanes` overlaps the card's forward and decode with the
host postprocess on a thread pool (``validate_workers``, default 4 with
more than two cores); ``validate_workers=0`` is the serial dispatch then
postprocess loop.  Both modes run on the same checkpoint in one process,
after one untimed warm-up pass, so the wall difference isolates the
overlap.  Their metrics must agree exactly (``metrics_equal``).

    python -m lanemapping_tpu_torch.tools.validate_ab --data-root <root> \\
        --ckpt <log_dir>/ckpt/best [--repeats 2] [--device cuda]

It writes ``<log-dir>/validate_ab.json`` unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from .soak_run import FLAGSHIP, card_provenance

MODES = (("serial_workers0", 0), ("pipelined_workers4", 4))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=FLAGSHIP)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--repeats", type=int, default=2,
                    help="timed repeats per mode; the best wall of each "
                    "mode is reported")
    ap.add_argument("--log-dir", default="validate_ab_logs")
    ap.add_argument("--out", default=None,
                    help="record path (default <log-dir>/validate_ab.json)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


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
    out = args.out or os.path.join(args.log_dir, "validate_ab.json")
    runner = Runner(cfg, log_dir=args.log_dir, device=device)
    load_model(os.path.abspath(args.ckpt), runner.state, cfg.get("seed", 0))
    runner.best_metric = float("inf")

    record = {"ckpt": os.path.abspath(args.ckpt), "batch": args.batch,
              **card_provenance(device), "date": time.strftime("%Y-%m-%d"),
              "modes": {}}

    # warm-up: the kernels' builds, the convolution algorithms, the GT
    # cache (timed against neither mode)
    t0 = time.time()
    runner.validate(max_batches=args.max_batches)
    record["warmup_wall_s"] = time.time() - t0

    for label, workers in MODES:
        runner.cfg.validate_workers = workers
        walls, metrics = [], None
        for _ in range(args.repeats):
            t0 = time.time()
            m = runner.validate(max_batches=args.max_batches)
            walls.append(time.time() - t0)
            metrics = {k: round(float(v), 4) for k, v in m.items()}
        record["modes"][label] = {"walls_s": walls,
                                  "best_wall_s": min(walls), **metrics}
        print(label, json.dumps(record["modes"][label]), flush=True)

    serial, piped = (record["modes"][label] for label, _ in MODES)
    record["speedup_serial_over_pipelined"] = \
        serial["best_wall_s"] / max(piped["best_wall_s"], 1e-9)
    record["metrics_equal"] = all(
        serial[k] == piped[k] for k in serial
        if k not in ("walls_s", "best_wall_s"))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print("[validate_ab]", json.dumps({
        "speedup": record["speedup_serial_over_pipelined"],
        "metrics_equal": record["metrics_equal"]}))
    return record


if __name__ == "__main__":
    main()
