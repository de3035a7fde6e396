"""Streaming lane mapping on the card: a dataset or raw ``.las`` clouds ->
lane JSONs.

Port of `tools/stream_map.py` (`:72-83, :119-158, :194-207` there).  Three
inputs, one per kind of config:

- ``--from-las`` (image configs): raw clouds from ``LasTiles``; each batch
  is rasterized on the card into the BEV tile
  (`ops/voxelize.py::bev_image_from_points`, on the K1 kernel).
- a LiDAR config (``use_lidar``): ``cfg.dataset.test`` (the
  ``LaserLaneProposalEgo`` dataset) with ``mode=--split``; the padded
  points and their mask go up as they are and the LidarEncoder voxelizes
  them on the card (K1z).  ``--from-las`` is refused here, as the JAX
  script cannot run that combination either.
- an image config without ``--from-las``: ``cfg.dataset.test`` image tiles,
  uploaded as uint8 (one channel when the batch is mono), divided by 255 in
  float32 on the card and then cast to the compute dtype.

``--split infer_only`` skips the label build.  The network runs in
``cfg.compute_dtype`` (bf16 on the flagship), except on the LiDAR path,
which computes what the JAX script computes there: float32 on bf16-rounded
weights (`models/nets.py::round_weights_as_flax_promotes`).  Decode runs in
float32, and the host postprocess (tracker, NMS, semantics, lane JSON) runs
on a worker pool while the next batch runs on the card.

    python -m lanemapping_tpu_torch.tools.stream_map <config> <data_root> \\
        [--from-las] [--split infer_only] [--ckpt model.pth] [--batch 8] \\
        [--device cuda]

One ``<out>/lanes_2d/<name>.json`` is written per tile.  Without ``--ckpt``
the weights are random, drawn from ``--seed`` (default ``cfg.seed``).

``main`` returns the run's numbers: tiles/s, and per stage the milliseconds
per batch (device time from CUDA events for upload, the input stage
(rasterize, voxelize or normalize), forward and decode; host time for the
postprocess workers).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

# the device stages of each input path, in order
STAGES = {"las": ("upload", "rasterize", "forward", "decode"),
          "lidar": ("upload", "voxelize", "forward", "decode"),
          "image": ("upload", "normalize", "forward", "decode")}


class StageClock:
    """Per-stage device time: CUDA events on a card, host clock on the CPU
    (where every op is synchronous)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[tuple] = []  # (stage, start, end)

    def now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def add(self, stage: str, start, end):
        self.marks.append((stage, start, end))

    def ms_per_stage(self) -> Dict[str, float]:
        if self.cuda:
            torch.cuda.synchronize()
        tot: Dict[str, List[float]] = {}
        for stage, a, b in self.marks:
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            tot.setdefault(stage, []).append(ms)
        return {s: float(np.mean(v)) for s, v in tot.items()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("data_root", help="dataset root (cropped_tiff/, las/, "
                    "labels/) or, with --from-las, a root holding las/*.las "
                    "or *.las")
    ap.add_argument("--from-las", action="store_true",
                    help="stream raw .las clouds into an image config, "
                    "rasterized on the card")
    ap.add_argument("--ckpt", default=None, help="torch state_dict (.pth)")
    ap.add_argument("--out", default="./map_out")
    ap.add_argument("--split", default="all")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=None,
                    help="random-weight seed when no --ckpt is given")
    ap.add_argument("--bench-json", action="store_true",
                    help="print the run's numbers as one JSON line")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    return ap.parse_args(argv)


def to_u8(proj: np.ndarray) -> np.ndarray:
    """[B,H,W,3] float tiles in [0, 1] -> uint8, one channel when the batch
    is mono (`tools/stream_map.py:194-201` there): dividing by 255 on the
    card gives back the same float32 values."""
    from ..engine.state import is_mono_batch

    a = np.rint(np.asarray(proj) * 255.0).astype(np.uint8)
    return np.ascontiguousarray(a[..., :1]) if is_mono_batch(a) else a


def main(argv=None) -> Dict:
    args = parse_args(argv)
    from ..api import load_checkpoint, resolve_device
    from ..config.config import Config, parse_dict_action
    from ..data.las_tiles import LasTiles
    from ..data.loader import Loader
    from ..decode.lane_decode import decode_lanes, host_decode_view
    from ..decode.postprocess import lane_maps_from_decode
    from ..models.nets import build_model, round_weights_as_flax_promotes
    from ..ops.voxelize import bev_image_from_points
    from ..registry import build_dataset
    from .export_lanes import lane_records
    from .las2bev import las2bev_params

    cfg = Config.fromfile(args.config)
    if args.overrides:
        cfg.merge_from_dict(parse_dict_action(args.overrides))
    if args.batch:
        cfg.batch_size = args.batch
    use_lidar = bool(cfg.get("use_lidar", False))
    if args.from_las and use_lidar:
        raise SystemExit(
            "[stream_map] --from-las rasterizes clouds into BEV tiles for an "
            "image config; a LiDAR config reads its clouds through "
            "cfg.dataset.test: drop --from-las")
    kind = "las" if args.from_las else "lidar" if use_lidar else "image"
    device = resolve_device(args.device)

    model = build_model(cfg, seed=cfg.get("seed", 0)
                        if args.seed is None else args.seed)
    if args.ckpt:
        load_checkpoint(model, args.ckpt)
    bf16 = cfg.get("compute_dtype") == "bfloat16"
    dtype = torch.bfloat16 if bf16 and not use_lidar else torch.float32
    if bf16 and use_lidar:
        round_weights_as_flax_promotes(model)
    model = model.to(device=device, dtype=dtype)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    if args.from_las:
        ds = LasTiles(args.data_root, mode=args.split, cfg=cfg)
    else:
        for split in ("train", "val", "test"):
            cfg.dataset[split]["data_root"] = args.data_root
        ds = build_dataset(dict(cfg.dataset.test, mode=args.split), cfg)
    loader = Loader(ds, batch_size=cfg.batch_size, shuffle=False,
                    drop_last=False, num_threads=8, prefetch=3)
    lanes_dir = os.path.join(args.out, "lanes_2d")
    os.makedirs(lanes_dir, exist_ok=True)
    las_p = las2bev_params(cfg)
    img = cfg.list_img_size_xy[0]
    need_detail = bool(cfg.get("view_detail", False))
    clock = StageClock(device)
    voxelized = []  # the clock mark at the end of the LiDAR voxelize stage
    if kind == "lidar":
        model.pcencoder.zfold_encoder.register_forward_pre_hook(
            lambda module, inputs: voxelized.append(clock.now()))

    def fwd_dec(batch, timed: bool):
        """One batch on the card: upload, input stage, forward, decode."""
        if kind == "image":
            host = (to_u8(batch["proj"]),)
        else:
            host = (np.asarray(batch["points"], np.float32),
                    np.asarray(batch["points_mask"], bool))
        t = [clock.now()]
        dev = [torch.from_numpy(a).to(device) for a in host]
        t.append(clock.now())
        with torch.inference_mode():
            if kind == "lidar":
                voxelized.clear()
                out = model({"points": dev[0], "points_mask": dev[1]})
                t.append(voxelized[0])
            else:
                if kind == "las":
                    x = bev_image_from_points(
                        *dev, las_p["pc_range"], img, gain=las_p["gain"],
                        bias=las_p["bias"], fill_iters=las_p["fill_iters"])
                    x = x[..., None]
                else:
                    # exact /255 in float32, then the compute dtype
                    x = dev[0].float() / 255.0
                x = x.to(dtype)
                x = x.expand(*x.shape[:-1], 3).contiguous()
                t.append(clock.now())
                out = model(x)
            t.append(clock.now())
            keep = host_decode_view(decode_lanes(out, cfg))
            if not need_detail:
                keep.pop("cls", None)
                keep.pop("cls_exp", None)
            # every host read of the conf rows is a comparison, which any
            # monotone map preserves: ship them as uint8 (as the JAX script)
            keep["bi_seg_rows"] = torch.round(torch.clamp(
                keep["bi_seg_rows"], 0.0, 1.0) * 255.0).to(torch.uint8)
            keep["prop_v_ext"] = keep["prop_v_ext"].to(torch.uint8)
            keep["orient"] = keep["orient"].to(torch.int8)
            t.append(clock.now())
        if timed:
            for stage, a, b in zip(STAGES[kind], t[:-1], t[1:]):
                clock.add(stage, a, b)
        return keep

    def postprocess(dec_dev, names):
        """Readback, then tracker/NMS/semantics and the JSONs, on a worker.
        Returns (lane arc length px, readback s, host postprocess s)."""
        t0 = time.perf_counter()
        dec = {k: v.cpu().numpy() for k, v in dec_dev.items()}
        t_read = time.perf_counter() - t0
        t0 = time.perf_counter()
        maps = lane_maps_from_decode(dec, cfg)
        px = 0.0
        for j, name in enumerate(names):
            recs = lane_records(maps["cls_offset_smooth"][j])
            for rec in recs:
                seq = np.asarray(rec["seq"], np.float64)[:, :2]
                if len(seq) > 1:
                    d = np.diff(seq, axis=0)
                    px += float(np.sum(np.hypot(d[:, 0], d[:, 1])))
            with open(os.path.join(lanes_dir, f"{name}.json"), "w") as f:
                json.dump(recs, f)
        return px, t_read, time.perf_counter() - t0

    stream = itertools.islice(iter(loader), args.max_batches)
    head = next(stream, None)
    if head is None:
        raise SystemExit("[stream_map] no tiles to process")
    # warm-up outside the timed region on the stream's own first batch,
    # which is then processed again inside the timed loop: builds the CUDA
    # kernels and the native tracker, picks the convolution algorithms
    postprocess(fwd_dec(head, timed=False), head["image_name"])
    if device.type == "cuda":
        torch.cuda.synchronize()

    n_tiles = n_batches = 0
    with ThreadPoolExecutor(6) as pool:
        t0 = time.perf_counter()
        pending = []
        for b in itertools.chain([head], stream):
            dec = fwd_dec(b, timed=True)
            pending.append(pool.submit(postprocess, dec, b["image_name"]))
            n_tiles += len(b["image_name"])
            n_batches += 1
        results = [p.result() for p in pending]
        wall = time.perf_counter() - t0
    stage_ms = clock.ms_per_stage()
    stage_ms["postprocess_host"] = \
        float(np.mean([r[2] for r in results])) * 1e3
    stage_ms["readback"] = float(np.mean([r[1] for r in results])) * 1e3
    lane_px = sum(r[0] for r in results)
    tiles_s = n_tiles / max(wall, 1e-9)
    km_lane_h = lane_px * cfg.get("img_reso", 0.05) / 1000.0 \
        / max(wall, 1e-9) * 3600.0
    rec = {
        "metric": "e2e_tiles_per_sec", "value": tiles_s, "unit": "tiles/s",
        "device": str(device), "n_tiles": n_tiles, "n_batches": n_batches,
        "batch": cfg.batch_size, "wall_s": wall, "km_lane_per_hour": km_lane_h,
        "input": kind, "points_per_tile": getattr(ds, "max_points", None),
        "stage_ms_per_batch": stage_ms,
        "dtype": str(dtype).replace("torch.", ""),
        "weights": os.path.abspath(args.ckpt) if args.ckpt else "random-init",
        "lanes_dir": lanes_dir,
    }
    print(f"[stream_map] {n_tiles} tiles in {wall:.3f}s "
          f"({tiles_s:.3f} tiles/s end-to-end on {device})")
    for s, ms in stage_ms.items():
        print(f"[stream_map] stage {s}: {ms:.3f} ms/batch")
    if args.bench_json:
        print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
