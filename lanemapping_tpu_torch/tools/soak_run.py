"""Scripted soak of the whole production loop on the card (port of the root
`tools/soak_run.py`).

Stages, each timed; the record is written to ``--out`` after every stage:

  train         training on a synthetic set to a plateau (bf16, remat off,
                the GT cache on), validation every ``--eval-ep`` epochs, the
                best checkpoint kept.
  validate      one validation pass with ``--ckpt`` (or the trained
                checkpoint) on ``--data-root``.
  endp          the endpoint-decode table (``endp_decode`` approx_topk /
                exact_topk / exact_host) on the trained checkpoint.  The
                port's approx_topk and exact_topk both take the exact
                ``torch.topk`` (`decode/lane_decode.py::decode_endpoints`),
                so their rows are equal by construction.
  refkit        the reference-exact occupancy filter against the default.
  refkit_lidar  the reference-exact LiDAR flags (first-10-points voxel
                mean, bicubic upsample) against the default.
  stream        ``stream_map --ckpt --preload`` of the trained checkpoint,
                with the 3-D lift and global merge when the data root has
                ``cropped_tiff_param``; a merged map must not be empty.
  lidar         raw-point streaming through the LidarEncoder
                (``--lidar-config``), with the trained checkpoint when the
                train stage used that config, else random weights.

    python -m lanemapping_tpu_torch.tools.soak_run --data-root <root> \\
        --log-dir <dir> --stages train,endp,refkit,stream --epochs 16 \\
        [--set seed=7] [--device cuda]

The record goes to ``<log-dir>/soak_run.json`` unless ``--out`` says
otherwise; its provenance names the card and its power limit, and
``launches`` holds each stage's K1 and K1z launches in this process.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FLAGSHIP = os.path.join(REPO, "configs", "Proj_polyline_fpn_vit_vertex_2.py")
LIDAR_CFG = os.path.join(REPO, "configs",
                         "Proj_polyline_lidarconv_vit_vertex_2.py")


def _save(out_path, record):
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)


def _train_cfg(args):
    """The soak's config: ``--config`` with bf16 training, remat off, the
    GT cache on, ``--batch``/``--epochs``/``--eval-ep``, a cosine schedule
    over the run's steps and every split on ``--data-root``; ``--set``
    overrides last (an ``epochs`` or ``batch_size`` among them re-derives
    ``total_iter`` and the schedule unless ``total_iter`` is set too)."""
    from ..config.config import Config, parse_dict_action
    cfg = Config.fromfile(args.config)
    cfg.train_compute_dtype = "bfloat16"
    cfg.remat = False
    cfg.batch_size = args.batch
    cfg.epochs = args.epochs
    cfg.eval_ep = args.eval_ep
    cfg.gt_cache = True
    cfg.save_ep = max(2, args.epochs // 4)
    with open(os.path.join(args.data_root, "data_split-shuffle.json")) as f:
        n_train = len(json.load(f)["train"])
    cfg.total_iter = (n_train // args.batch) * args.epochs
    cfg.scheduler = dict(type="CosineAnnealingLR", T_max=cfg.total_iter)
    for s in ("train", "val", "test"):
        cfg.dataset[s]["data_root"] = args.data_root
    if args.set:
        overrides = parse_dict_action(args.set)
        cfg.merge_from_dict(overrides)
        if ("epochs" in overrides or "batch_size" in overrides) \
                and "total_iter" not in overrides:
            cfg.total_iter = (n_train // cfg.batch_size) * cfg.epochs
            cfg.scheduler = dict(type="CosineAnnealingLR",
                                 T_max=cfg.total_iter)
    return cfg


def stage_train(args, rec):
    from ..engine.runner import Runner
    cfg = _train_cfg(args)
    os.makedirs(args.log_dir, exist_ok=True)
    runner = Runner(cfg, log_dir=args.log_dir, device=args.device)
    resumed = runner.resume_latest()
    t0 = time.time()
    runner.train()
    wall = time.time() - t0
    curve = []
    val_path = os.path.join(args.log_dir, "val.jsonl")
    if os.path.isfile(val_path):
        with open(val_path) as f:
            curve = [json.loads(line) for line in f if line.strip()]
    rec["train"] = {
        "wall_s": wall,
        "resumed": resumed,
        "epochs": cfg.epochs,
        "batch": cfg.batch_size,
        "steps": int(runner.state.step),
        "val_curve": [{k: round(v, 4) for k, v in c.items()
                       if isinstance(v, float)} for c in curve],
        "best_composite": round(runner.best_metric, 4),
        "ckpt": os.path.join(args.log_dir, "ckpt", "best"),
        "config": os.path.abspath(args.config),
    }
    del runner
    _free(args.device)


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _validate_with(args, ckpt, overrides, max_batches=None):
    """One validation pass of a fresh Runner of the soak's config with
    ``overrides`` set, from ``ckpt``: the metrics rounded to 4 places and
    the pass's wall seconds.  The Runner never saves a ``best`` here."""
    from ..engine.checkpoint import load_model
    from ..engine.runner import Runner
    cfg = _train_cfg(args)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    runner = Runner(cfg, log_dir=os.path.join(args.log_dir, "eval_tmp"),
                    device=args.device)
    load_model(ckpt, runner.state, cfg.get("seed", 0))
    runner.best_metric = float("inf")
    t0 = time.time()
    m = runner.validate(max_batches=max_batches)
    m = {k: round(float(v), 4) for k, v in m.items()}
    m["wall_s"] = time.time() - t0
    # up to three Runners run back to back in one stage
    del runner
    _free(args.device)
    return m


def _ckpt(args, rec, stage):
    ckpt = rec.get("train", {}).get("ckpt") or args.ckpt
    assert ckpt, f"{stage} stage needs a checkpoint (run train or pass --ckpt)"
    return ckpt


def stage_validate(args, rec):
    """Evaluation alone on ``--data-root`` (e.g. a hard-geometry set scored
    with a checkpoint trained on the benign set)."""
    ckpt = _ckpt(args, rec, "validate")
    rec["validate"] = {"ckpt": ckpt, "data_root": args.data_root,
                       **_validate_with(args, ckpt, {})}


def stage_endp(args, rec):
    ckpt = _ckpt(args, rec, "endp")
    table = {mode: _validate_with(args, ckpt, {"endp_decode": mode})
             for mode in ("approx_topk", "exact_topk", "exact_host")}
    rec["endp_decode_table"] = {"ckpt": ckpt, **table}


def stage_refkit(args, rec):
    ckpt = _ckpt(args, rec, "refkit")
    rec["ref_exact_occupancy_filter"] = {
        "default": _validate_with(args, ckpt, {}),
        "ref_exact": _validate_with(args, ckpt,
                                    {"ref_exact_occupancy_filter": True}),
    }


def stage_refkit_lidar(args, rec):
    """Reference-exact LiDAR deltas on a trained checkpoint: the
    first-10-points voxel mean (mmdet3d ``max_num_points``) and the bicubic
    ``align_corners=False`` upsample (reference `lidarencoder.py:70-81`)."""
    ckpt = _ckpt(args, rec, "refkit_lidar")
    rec["ref_exact_lidar"] = {
        "ckpt": ckpt,
        "default": _validate_with(args, ckpt, {}),
        "voxel_cap_first10": _validate_with(
            args, ckpt, {"ref_exact_voxel_cap": True}),
        "bicubic_upsample": _validate_with(
            args, ckpt, {"ref_exact_bicubic_upsample": True}),
    }


def stream_cmd(config, data_root, *extra):
    """The command line of one ``stream_map`` run in a child process."""
    return [sys.executable, "-m", "lanemapping_tpu_torch.tools.stream_map",
            config, data_root, *extra]


def run_stream(cmd, timeout=None):
    """Runs a ``stream_map`` command from the repo root; (the finished
    process, its ``--bench-json`` record or None)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                       env=env, timeout=timeout)
    bench = None
    for line in p.stdout.splitlines():
        line = line.strip()
        if line.startswith("{") and "tiles" in line:
            try:
                bench = json.loads(line)
            except json.JSONDecodeError:
                pass
    return p, bench


def stage_stream(args, rec):
    ckpt = _ckpt(args, rec, "stream")
    out_dir = os.path.join(args.log_dir, "map_out")
    params_dir = os.path.join(args.data_root, "cropped_tiff_param")
    t0 = time.time()
    cmd = stream_cmd(args.config, args.data_root, "--ckpt", ckpt, "--out",
                     out_dir, "--split", "infer_only", "--batch", "16",
                     "--preload", "--bench-json", "--max-batches",
                     str(args.stream_batches), "--device", args.device)
    if os.path.isdir(params_dir):
        cmd += ["--params-dir", params_dir]
    p, bench = run_stream(cmd)
    entry = {"wall_s": time.time() - t0, "bench": bench,
             "rc": p.returncode}
    if p.returncode != 0:
        entry["stderr_tail"] = p.stderr[-2000:]
    # the global map: the 3-D lift and merge must give polylines
    merged = None
    for line in p.stdout.splitlines():
        if "global map:" in line:
            merged = line.split("global map:", 1)[1].strip()
    if merged and os.path.isfile(merged):
        with open(merged) as f:
            n_lines = sum(1 for _ in f)
        entry["merged_map"] = merged
        entry["merged_lines"] = n_lines
        assert n_lines > 0, "merged global map is empty"
    rec["stream_bev"] = entry


def stage_lidar(args, rec):
    lidar_root = args.lidar_root or os.path.join(
        os.path.dirname(args.data_root.rstrip("/")), "synth_lidar")
    if not os.path.isdir(os.path.join(lidar_root, "las")):
        from ..data.synthetic import generate_dataset
        t0 = time.time()
        generate_dataset(lidar_root, n_tiles=args.lidar_tiles, img=1152,
                         seed=7, with_points=True,
                         points_per_tile=args.lidar_points)
        print(f"[soak] generated {args.lidar_tiles} lidar tiles in "
              f"{time.time() - t0:.0f}s")
    t0 = time.time()
    # the override goes before the options: argparse takes the
    # positionals in one run
    cmd = stream_cmd(args.lidar_config, lidar_root,
                     f"max_points={args.lidar_points}", "--out",
                     os.path.join(args.log_dir, "map_out_lidar"), "--split",
                     "all", "--batch", "4", "--bench-json", "--device",
                     args.device)
    # the trained checkpoint fits the LidarEncoder only when the train
    # stage used the LiDAR config; else the weights are random
    trained = rec.get("train", {})
    lidar_ckpt = args.lidar_ckpt or (
        trained.get("ckpt")
        if trained.get("config") == os.path.abspath(args.lidar_config)
        else None)
    if lidar_ckpt:
        cmd += ["--ckpt", lidar_ckpt]
    p, bench = run_stream(cmd)
    entry = {"wall_s": time.time() - t0, "bench": bench,
             "rc": p.returncode,
             "points_per_tile": args.lidar_points,
             "ckpt": lidar_ckpt}
    if bench and bench.get("value"):
        entry["points_per_sec"] = round(
            bench["value"] * args.lidar_points, 0)
    if p.returncode != 0:
        entry["stderr_tail"] = p.stderr[-2000:]
    rec["stream_lidar"] = entry


STAGES = {"train": stage_train, "validate": stage_validate,
          "endp": stage_endp, "refkit": stage_refkit,
          "refkit_lidar": stage_refkit_lidar, "stream": stage_stream,
          "lidar": stage_lidar}


def card_provenance(device) -> dict:
    """The device's name, and for a card its power limit as ``nvidia-smi``
    reads it (None where that tool is missing)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": str(device)}
    try:
        power = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except FileNotFoundError:
        power = None
    return {"device": str(device),
            "card": torch.cuda.get_device_name(device),
            "nvidia_smi_name_power_limit": power}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=FLAGSHIP)
    ap.add_argument("--lidar-config", default=LIDAR_CFG)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--stages", default="train,endp,refkit,stream,lidar")
    ap.add_argument("--epochs", type=int, default=16)
    ap.add_argument("--eval-ep", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--log-dir", default="soak_logs")
    ap.add_argument("--ckpt", default=None,
                    help="existing checkpoint (skip train)")
    ap.add_argument("--out", default=None,
                    help="record path (default <log-dir>/soak_run.json)")
    ap.add_argument("--stream-batches", type=int, default=8)
    ap.add_argument("--lidar-root", default=None)
    ap.add_argument("--lidar-tiles", type=int, default=24)
    ap.add_argument("--lidar-points", type=int, default=1 << 19)
    ap.add_argument("--lidar-ckpt", default=None)
    ap.add_argument("--set", action="append", default=[],
                    help="extra cfg overrides key=value (literal-evaled)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from ..api import resolve_device
    from ..kernels.bev_bin import bev_bin_mean
    from ..kernels.voxel_bin import voxel_bin_mean

    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.log_dir, exist_ok=True)
    out = args.out or os.path.join(args.log_dir, "soak_run.json")
    rec = {}
    if os.path.isfile(out):
        with open(out) as f:
            rec = json.load(f)
    rec.setdefault("provenance", {})
    rec["provenance"].update({
        "data_root": args.data_root,
        "torch": torch.__version__,
        **card_provenance(device),
        "date": time.strftime("%Y-%m-%d"),
    })
    kernels = (bev_bin_mean, voxel_bin_mean)
    for name in args.stages.split(","):
        name = name.strip()
        if not name:
            continue
        print(f"[soak] === stage {name} ===", flush=True)
        t0 = time.time()
        before = {k.__name__: k.launches for k in kernels}
        STAGES[name](args, rec)
        # the binning kernels' launches in this process (a stream's child
        # process counts its own, in its bench record)
        rec.setdefault("launches", {})[name] = {
            k.__name__: k.launches - before[k.__name__] for k in kernels}
        print(f"[soak] stage {name} done in {time.time() - t0:.0f}s; "
              f"launches {rec['launches'][name]}", flush=True)
        _save(out, rec)
    print(f"[soak] record written to {out}")
    return rec


if __name__ == "__main__":
    main()
