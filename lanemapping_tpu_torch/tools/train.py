"""Training CLI (port of the root `tools/train.py`).

    python -m lanemapping_tpu_torch.tools.train <config> [key=value ...] \\
        [--max-iters N] [--resume LOG_DIR] [--device cuda]

The config path is an argument and dotted ``key=value`` overrides follow
it (``optimizer.lr=1e-4``).  A run logs to ``<cfg.log_dir>/<timestamp>``
(a copy of the config, ``train.jsonl``, ``val.jsonl``, ``ckpt/``), or, with
``--resume``, goes on in that log dir from its newest checkpoint with the
full state.  It runs on the card unless ``--device cpu`` is given.

When the config's mesh (`parallel/mesh.py::make_mesh`: ``mesh_shape``,
the flagship's ``data=-1`` taking every local card) has more than one card
and no process group exists yet, it starts one rank per card with
``torch.multiprocessing.spawn`` and a free local port; each rank takes its
card and the NCCL backend (`parallel/dist.py`) and trains its slice of
every global batch of ``cfg.batch_size``.  ``main`` then returns None in
the launching process.  With one card, or a group already started (the
``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID`` environment),
it trains in this process.
"""

from __future__ import annotations

import argparse
import datetime
import os
import shutil
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train a lane-mapping model")
    ap.add_argument("config", help="path to a python config file")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    ap.add_argument("--max-iters", type=int, default=None,
                    help="stop after N iterations (smoke runs)")
    ap.add_argument("--resume", default=None,
                    help="log dir of a previous run to resume (full state)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _rank_main(rank: int, world: int, port: int, argv, log_dir: str,
               mesh) -> None:
    """One rank of a multi-card run (a ``torch.multiprocessing.spawn``
    target)."""
    from ..parallel.dist import maybe_initialize_distributed, shutdown

    device = maybe_initialize_distributed(
        coordinator=f"127.0.0.1:{port}", num_processes=world,
        process_id=rank, devices=mesh)
    try:
        _train(parse_args(argv), log_dir, device)
    finally:
        shutdown()


def _train(args, log_dir, device):
    from ..config.config import Config, parse_dict_action
    from ..engine.runner import Runner
    from ..parallel.dist import dist_print

    cfg = Config.fromfile(args.config)
    if args.overrides:
        cfg.merge_from_dict(parse_dict_action(args.overrides))
    runner = Runner(cfg, log_dir=log_dir, device=device)
    if args.resume and runner.resume_latest():
        dist_print(f"[train] resumed from {args.resume} at step "
                   f"{runner.state.step}")
    runner.train(max_iters=args.max_iters)
    dist_print("[train] done")
    return runner


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    import torch.distributed as tdist
    import torch.multiprocessing as mp

    from ..config.config import Config, parse_dict_action
    from ..parallel.dist import free_port, maybe_initialize_distributed
    from ..parallel.mesh import make_mesh

    cfg = Config.fromfile(args.config)
    if args.overrides:
        cfg.merge_from_dict(parse_dict_action(args.overrides))

    if args.resume:
        log_dir = args.resume
    else:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
        log_dir = os.path.join(cfg.get("log_dir", "./logs"), stamp)
        os.makedirs(log_dir, exist_ok=True)
        shutil.copy2(args.config, os.path.join(
            log_dir, os.path.basename(args.config)))
    print(f"[train] config={args.config} log_dir={log_dir}")

    mesh = make_mesh(cfg, device=args.device)
    device = args.device
    if not tdist.is_initialized():
        # a group from the environment (one process per rank, started
        # elsewhere) takes precedence over spawning one
        device = maybe_initialize_distributed(devices=mesh) or device
    if not tdist.is_initialized() and len(mesh) > 1:
        print(f"[train] {len(mesh)} ranks, one per card: "
              f"{[str(d) for d in mesh]}")
        mp.spawn(_rank_main, args=(len(mesh), free_port(), argv, log_dir,
                                   mesh), nprocs=len(mesh), join=True)
        return None
    return _train(args, log_dir, device)


if __name__ == "__main__":
    main()
