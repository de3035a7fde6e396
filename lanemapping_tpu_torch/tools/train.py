"""Training CLI (port of the root `tools/train.py`).

    python -m lanemapping_tpu_torch.tools.train <config> [key=value ...] \\
        [--max-iters N] [--resume LOG_DIR] [--device cuda]

The config path is an argument and dotted ``key=value`` overrides follow
it (``optimizer.lr=1e-4``).  A run logs to ``<cfg.log_dir>/<timestamp>``
(a copy of the config, ``train.jsonl``, ``val.jsonl``, ``ckpt/``), or, with
``--resume``, goes on in that log dir from its newest checkpoint with the
full state.  It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import datetime
import os
import shutil


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


def main(argv=None):
    args = parse_args(argv)
    from ..config.config import Config, parse_dict_action
    from ..engine.runner import Runner

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

    runner = Runner(cfg, log_dir=log_dir, device=args.device)
    if args.resume and runner.resume_latest():
        print(f"[train] resumed from {args.resume} at step "
              f"{runner.state.step}")
    runner.train(max_iters=args.max_iters)
    print("[train] done")
    return runner


if __name__ == "__main__":
    main()
