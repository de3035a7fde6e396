"""Evaluation and export CLI (port of the root `tools/infer.py`).

    python -m lanemapping_tpu_torch.tools.infer <config> [key=value ...] \\
        [--ckpt CKPT] [--split test|val] [--max-batches N] \\
        [--save-lanes DIR] [--view] [--device cuda]

Validates the config's net on a split (the metrics of its net and head:
lane, grid or segmentation F1) and prints them as JSON, then with
``--save-lanes`` runs the export driver of the net and head: one lane JSON
per tile (ColumnProposal2, RowSharNotReducRef, GridSeg) or the Segmentor's
pooled metrics, with ``--view`` the overlay PNGs beside them.  ``--ckpt``
is a Runner checkpoint directory (``<log_dir>/ckpt/<tag>``) or a torch
``state_dict`` file; only its weights are read, whatever device it was
saved on.  It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Evaluate / infer lane maps")
    ap.add_argument("config")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory or state_dict file to load")
    ap.add_argument("--split", default="test", choices=["test", "val"])
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--save-lanes", default=None,
                    help="directory for the per-tile lane JSONs")
    ap.add_argument("--view", action="store_true",
                    help="also write overlay PNGs beside the lane JSONs")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from ..api import load_checkpoint
    from ..config.config import Config, parse_dict_action
    from ..data.loader import build_dataloader
    from ..engine.runner import KLANE_HEADS, Runner

    cfg = Config.fromfile(args.config)
    if args.overrides:
        cfg.merge_from_dict(parse_dict_action(args.overrides))
    runner = Runner(cfg, device=args.device)
    if args.ckpt:
        load_checkpoint(runner.model, os.path.abspath(args.ckpt))

    split_cfg = cfg.dataset[args.split if args.split in cfg.dataset
                            else "test"]
    t0 = time.time()
    metrics = runner.validate(
        loader=build_dataloader(split_cfg, cfg, is_train=False),
        max_batches=args.max_batches)
    result = {"metrics": metrics, "wall_s": round(time.time() - t0, 2)}
    print(json.dumps(result))

    if args.save_lanes:
        loader = build_dataloader(split_cfg, cfg, is_train=False)
        kw = dict(max_batches=args.max_batches, write_view=args.view)
        if cfg.net.type == "Segmentor":
            result["segmentor_infer"] = runner.infer_segmentor_and_export(
                loader, args.save_lanes, **kw)
            print(json.dumps({"segmentor_infer":
                              result["segmentor_infer"]}))
            print(f"[infer] segmentor maps written to {args.save_lanes}")
        elif runner.head_type in KLANE_HEADS:
            runner.infer_grid_and_export(loader, args.save_lanes, **kw)
            print(f"[infer] grid-head lane seqs written to "
                  f"{args.save_lanes}")
        else:
            runner.infer_and_export(loader, args.save_lanes, **kw)
            print(f"[infer] lane seqs written to {args.save_lanes}")
    return result


if __name__ == "__main__":
    main()
