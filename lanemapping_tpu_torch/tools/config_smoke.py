"""Smoke of the four non-flagship configs on the card (port of the root
`tools/config_smoke.py`).

Each config trains ``--steps`` real steps at full size (batch ``--batch``,
one epoch, the GT cache on, bf16, remat) with the port's ``Runner``, then
validates ``--val-batches`` batches; s/step comes from CUDA events after
the first step (which builds kernels and runs cuDNN's autotune), and the
record keeps the first and last loss and the config's own validation
metrics.  A config that fails records its error and the others run.

    python -m lanemapping_tpu_torch.tools.config_smoke --data-root <root> \\
        [--configs NAME_OR_PATH ...] [--steps 50] [--batch 4] \\
        [--val-batches 8] [--log-dir DIR] [--device cuda]

``<root>`` is a LaserLane set (`data/synthetic.py::generate_dataset`).  A
config is a name under ``configs/`` or a path.  The record goes to
``<log-dir>/config_smoke.json`` unless ``--out`` names a file; an existing
record is merged, each entry keeping the provenance it was measured under.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback
from typing import Dict

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIGS = ["Proj28_GFC-T3_RowRef_82_73_laser",
           "Proj28_GFC-T3_Seg_82_11_laser",
           "Proj_polyline_fpn_mixseg_vertex",
           "Proj_FPN_Seg"]


def config_path(name: str) -> str:
    if name.endswith(".py") or os.path.sep in name:
        return name
    return os.path.join(REPO, "configs", name + ".py")


def config_label(name: str) -> str:
    return os.path.splitext(os.path.basename(name))[0]


def smoke_one(name: str, args) -> Dict:
    import torch

    from ..config.config import Config
    from ..data.loader import build_dataloader
    from ..engine.runner import Runner
    from .bench import elapsed_ms

    cfg = Config.fromfile(config_path(name))
    cfg.batch_size = args.batch
    cfg.epochs = 1
    cfg.gt_cache = True
    cfg.train_compute_dtype = "bfloat16"
    cfg.remat = True
    cfg.log_every = 10
    for s in ("train", "val", "test"):
        cfg.dataset[s]["data_root"] = args.data_root
    label = config_label(name)
    runner = Runner(cfg, log_dir=os.path.join(args.log_dir, label),
                    device=args.device)
    device = runner.device

    # a manual step loop, so the first step stays out of the s/step
    loader = build_dataloader(cfg.dataset.train, cfg, is_train=True)
    it = iter(loader)

    def next_batch():
        nonlocal it
        try:
            return next(it)
        except StopIteration:
            it = iter(loader)
            return next(it)

    def one_step():
        return runner.train_step(runner.state,
                                 runner._device_batch(next_batch()))

    t0 = time.perf_counter()
    losses = [float(one_step()["loss"])]
    compile_wall = time.perf_counter() - t0
    last = {}
    n_timed = args.steps - 1

    def timed():
        last["stats"] = one_step()

    ms = elapsed_ms(device, timed, n_timed) if n_timed > 0 else 0.0
    if n_timed > 0:
        losses.append(float(last["stats"]["loss"]))
    sec_per_step = ms / 1e3 / max(n_timed, 1)

    t_val = time.perf_counter()
    metrics = runner.validate(max_batches=args.val_batches)
    val_wall = time.perf_counter() - t_val
    entry = {
        "config": label,
        "batch": args.batch,
        "steps": args.steps,
        "compile_plus_first_step_s": round(compile_wall, 3),
        "sec_per_step": round(sec_per_step, 5),
        "loss_first": round(losses[0], 4),
        "loss_last": round(losses[-1], 4),
        "loss_decreased": bool(losses[-1] < losses[0]),
        "val_wall_s": round(val_wall, 3),
        "val": {k: round(float(v), 4) for k, v in metrics.items()},
    }
    del runner, loader, it
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return entry


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--configs", nargs="+", default=CONFIGS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--val-batches", type=int, default=8)
    ap.add_argument("--log-dir", default="config_smoke_logs")
    ap.add_argument("--out", default=None,
                    help="record path (default <log-dir>/config_smoke.json)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    from ..api import resolve_device
    from .soak_run import card_provenance

    args = parse_args(argv)
    device = resolve_device(args.device)
    out = args.out or os.path.join(args.log_dir, "config_smoke.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    provenance = {"data_root": os.path.abspath(args.data_root),
                  **card_provenance(device),
                  "date": time.strftime("%Y-%m-%d")}
    record = {"provenance": provenance, "configs": {}}
    if os.path.isfile(out):
        # merge-resume: earlier configs' entries keep the provenance they
        # were measured under
        with open(out) as f:
            prior = json.load(f)
        for k, v in prior.get("configs", {}).items():
            v.setdefault("provenance", prior.get("provenance", {}))
            record["configs"][k] = v

    for name in args.configs:
        print(f"[config_smoke] === {name} ===", flush=True)
        try:
            entry = smoke_one(name, args)
        except Exception:
            # a failing config is recorded; the others still run
            entry = {"config": config_label(name),
                     "error": traceback.format_exc()[-2000:]}
        entry["provenance"] = dict(provenance)
        record["configs"][entry["config"]] = entry
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
        print(json.dumps(entry)[:600], flush=True)
    return record


if __name__ == "__main__":
    main()
