"""Multi-rank training and validation of the port against its own
single-process run (counterpart of the root `tools/multihost_test.py`).

    python -m lanemapping_tpu_torch.tools.multihost_test \\
        [--out MULTIHOST_TORCH.json] [--nprocs-max 4] [--device cuda]

It generates a 32-tile synthetic dataset (192 px; 16 train tiles), then
runs ``Runner.train`` for ``--steps`` steps of global batch ``--batch``
and ``Runner.validate(max_batches=2)`` at ``configs/tiny_test.py``: once
in one process (no process group), once on 2 ranks and, with
``--nprocs-max 4``, once on 4, each rank a process of
``torch.multiprocessing.spawn`` on ``127.0.0.1`` with a free port.  Ranks
on the CPU, or sharing one card (``--device cuda`` on a one-card machine),
use gloo; ranks with a card each, NCCL (`parallel/dist.py`).  It runs on
the card unless ``--device cpu`` is given.  Each
multi-rank run is held to the single process at the root tool's bars
(`tools/multihost_test.py:171-198` there): the logged losses within rel
1e-3, the parameter digest (the sum of ``|p|`` in float64) within rel
1e-5, every validation metric within abs 5e-2, and every rank's
parameters and buffers bit-identical to rank 0's.  It writes one JSON
(``--out``) and exits non-zero when a bar is missed.

``run_regime`` is the same run as a function (the CPU tests call it).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = os.path.join(REPO, "configs", "tiny_test.py")
BARS = {"loss_rel": 1e-3, "digest_rel": 1e-5, "metric_abs": 5e-2}


def make_dataset(root: str) -> str:
    """The root tool's 32 tiles: train 16, valid 8, test 8."""
    from ..data.synthetic import generate_dataset
    if not os.path.isdir(os.path.join(root, "cropped_tiff")):
        stems = [f"{190000 + i:06d}_{i:04d}" for i in range(32)]
        generate_dataset(root, n_tiles=32, img=192, seed=5,
                         splits={"train": stems[:16], "valid": stems[16:24],
                                 "test": stems[24:], "single": stems[:1],
                                 "pretrain": stems})
    return root


def build_cfg(root: str, log_dir: str, batch: int, config: str = TINY,
              overrides: Optional[Dict] = None):
    from ..config.config import Config
    cfg = Config.fromfile(config)
    cfg.batch_size = batch
    cfg.workers = 0
    cfg.log_every = 1
    cfg.log_dir = log_dir
    cfg.epochs = 10 ** 6  # max_iters ends the run
    cfg.eval_ep = cfg.save_ep = 10 ** 6  # validate once, after the steps
    for s in ("train", "val", "test"):
        cfg.dataset[s]["data_root"] = root
    if overrides:
        cfg.merge_from_dict(dict(overrides))
    return cfg


def state_digest(model) -> Dict:
    """The sum of ``|p|`` over the parameters (float64) and a SHA-256 of
    every parameter's and buffer's bytes."""
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    digest = float(sum(p.detach().double().abs().sum().item()
                       for p in model.parameters()))
    return {"param_digest": digest, "sha256": h.hexdigest()}


def member(rank: int, world: int, port: int, root: str, log_dir: str,
           out: str, device: str, steps: int, batch: int,
           overrides: Optional[Dict], threads: int,
           init_from: Optional[str]) -> None:
    """One rank of a run (world 1: the single process, no group).  Rank 0
    writes ``out``: the logged losses, the validation metrics, the digest,
    and every rank's SHA-256."""
    import torch
    torch.set_num_threads(threads)
    from ..engine.checkpoint import load_network_filtered
    from ..engine.runner import Runner
    from ..parallel.dist import (all_gather_host, get_world_size,
                                 is_main_process,
                                 maybe_initialize_distributed, shutdown)
    from ..parallel.mesh import make_mesh

    dev = device
    if world > 1:
        dev = maybe_initialize_distributed(
            coordinator=f"127.0.0.1:{port}", num_processes=world,
            process_id=rank, devices=make_mesh(device=device))
    try:
        cfg = build_cfg(root, log_dir, batch, overrides=overrides)
        runner = Runner(cfg, log_dir=log_dir, device=dev)
        runner._tb = None  # the run is read from train.jsonl
        if init_from:
            load_network_filtered(init_from, runner.state)
        runner.train(max_iters=steps)
        metrics = runner.validate(max_batches=2)
        digests = all_gather_host(state_digest(runner.model))
        if is_main_process():
            with open(os.path.join(log_dir, "train.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            with open(out, "w") as f:
                json.dump({"losses": [r["loss"] for r in recs],
                           "records": recs, "val": metrics,
                           "param_digest": digests[0]["param_digest"],
                           "rank_sha256": [d["sha256"] for d in digests],
                           "world": get_world_size()}, f)
    finally:
        shutdown()


def run_regime(world: int, root: str, work: str, device: str = "cuda",
               steps: int = 6, batch: int = 8,
               overrides: Optional[Dict] = None, threads: int = 1,
               init_from: Optional[str] = None, tag: str = "") -> Dict:
    """Train and validate on ``world`` ranks (each a spawned process);
    rank 0's record."""
    import torch.multiprocessing as mp

    from ..parallel.dist import free_port
    name = f"{tag}{world}rank"
    log_dir = os.path.join(work, f"logs_{name}")
    out = os.path.join(work, f"{name}.json")
    mp.spawn(member, args=(world, free_port(), root, log_dir, out, device,
                           steps, batch, overrides, threads, init_from),
             nprocs=world, join=True)
    with open(out) as f:
        return json.load(f)


def compare(a: Dict, b: Dict) -> Dict:
    """``b`` (N ranks) against ``a`` (one process) at the root tool's
    bars."""
    la, lb = np.asarray(a["losses"]), np.asarray(b["losses"])
    loss_rel = float(np.max(np.abs(la - lb) / np.maximum(np.abs(la), 1.0)))
    dig_rel = abs(a["param_digest"] - b["param_digest"]) / a["param_digest"]
    val = {k: abs(a["val"][k] - b["val"][k]) for k in a["val"]}
    ranks_equal = len(set(b["rank_sha256"])) == 1
    ok = (la.shape == lb.shape and loss_rel < BARS["loss_rel"]
          and dig_rel < BARS["digest_rel"]
          and all(v < BARS["metric_abs"] for v in val.values())
          and ranks_equal)
    return {"max_rel_loss_diff": loss_rel, "param_digest_rel_diff": dig_rel,
            "val_metric_abs_diff": val, "ranks_bit_identical": ranks_equal,
            "pass": bool(ok)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="MULTIHOST_TORCH.json")
    ap.add_argument("--nprocs-max", type=int, default=2,
                    help="deepest split to run (4 adds a 4-rank run)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--work-dir", default=None)
    args = ap.parse_args(argv)
    work = args.work_dir or tempfile.mkdtemp(prefix="multihost_torch_")
    root = make_dataset(os.path.join(work, "tiles"))
    record = {"config": "tiny_test.py", "batch": args.batch,
              "steps": args.steps, "device": args.device, "bars": BARS}
    worlds = [1, 2] + ([4] if args.nprocs_max >= 4 else [])
    runs = {}
    for world in worlds:
        t0 = time.perf_counter()
        runs[world] = run_regime(world, root, work, args.device,
                                 args.steps, args.batch)
        record[f"{world}rank"] = {**runs[world],
                                  "wall_s": time.perf_counter() - t0}
    record["compare"] = {f"{w}rank": compare(runs[1], runs[w])
                         for w in worlds[1:]}
    record["pass"] = all(c["pass"] for c in record["compare"].values())
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"pass": record["pass"], **record["compare"]}))
    return 0 if record["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
