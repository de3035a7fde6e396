"""Streaming lane mapping on the card: raw ``.las`` clouds -> lane JSONs.

Port of `tools/stream_map.py --from-las` (`:119-158` there).  Per batch of
clouds: upload the padded point buffers, rasterize them on the card into
the BEV tile (`ops/voxelize.py::bev_image_from_points`, on the K1 binning
kernel), run the network in ``cfg.compute_dtype`` (bf16 on the flagship),
decode in float32, and hand the host postprocess (tracker, NMS, semantics,
lane JSON) to a worker pool while the next batch runs on the card.

    python -m lanemapping_tpu_torch.tools.stream_map <config> <data_root> \\
        --from-las [--ckpt model.pth] [--batch 8] [--device cuda]

``<data_root>/las/*.las`` (or ``<data_root>/*.las``) are the clouds; one
``<out>/lanes_2d/<stem>.json`` is written per tile.  Without ``--ckpt`` the
weights are random, drawn from ``--seed`` (default ``cfg.seed``).  The
image-tile input of the JAX script (the LaserLane dataset) is not ported
yet: `api.LaneMapper.map_tiles` maps image tiles.

``main`` returns the run's numbers: tiles/s, and per stage the milliseconds
per batch (device time from CUDA events for upload, rasterize, forward and
decode; host time for the postprocess workers).
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

STAGES = ("upload", "rasterize", "forward", "decode")


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
    ap.add_argument("data_root", help="root holding las/*.las or *.las")
    ap.add_argument("--from-las", action="store_true",
                    help="stream raw .las clouds (the only input ported)")
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


def main(argv=None) -> Dict:
    args = parse_args(argv)
    from ..api import load_checkpoint, resolve_device
    from ..config.config import Config, parse_dict_action
    from ..data.las_tiles import LasTiles
    from ..data.loader import Loader
    from ..decode.lane_decode import decode_lanes, host_decode_view
    from ..decode.postprocess import lane_maps_from_decode
    from ..models.nets import build_model
    from ..ops.voxelize import bev_image_from_points
    from .export_lanes import lane_records
    from .las2bev import las2bev_params

    if not args.from_las:
        raise SystemExit("[stream_map] only --from-las is ported; map image "
                         "tiles with lanemapping_tpu_torch.LaneMapper")
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    if args.overrides:
        cfg.merge_from_dict(parse_dict_action(args.overrides))
    if args.batch:
        cfg.batch_size = args.batch

    model = build_model(cfg, seed=cfg.get("seed", 0)
                        if args.seed is None else args.seed)
    if args.ckpt:
        load_checkpoint(model, args.ckpt)
    dtype = torch.bfloat16 if cfg.get("compute_dtype") == "bfloat16" \
        else torch.float32
    model = model.to(device=device, dtype=dtype)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    ds = LasTiles(args.data_root, mode=args.split, cfg=cfg)
    loader = Loader(ds, batch_size=cfg.batch_size, shuffle=False,
                    drop_last=False, num_threads=8, prefetch=3)
    lanes_dir = os.path.join(args.out, "lanes_2d")
    os.makedirs(lanes_dir, exist_ok=True)
    las_p = las2bev_params(cfg)
    img = cfg.list_img_size_xy[0]
    need_detail = bool(cfg.get("view_detail", False))
    clock = StageClock(device)

    def fwd_dec(batch, timed: bool):
        """One batch on the card: upload, rasterize, forward, decode."""
        t = [clock.now()]
        pts = torch.from_numpy(np.asarray(batch["points"], np.float32))
        msk = torch.from_numpy(np.asarray(batch["points_mask"], bool))
        pts, msk = pts.to(device), msk.to(device)
        t.append(clock.now())
        with torch.inference_mode():
            x = bev_image_from_points(
                pts, msk, las_p["pc_range"], img, gain=las_p["gain"],
                bias=las_p["bias"], fill_iters=las_p["fill_iters"])
            x = x[..., None].to(dtype).expand(*x.shape, 3).contiguous()
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
            for stage, a, b in zip(STAGES, t[:-1], t[1:]):
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
        raise SystemExit("[stream_map] no clouds to process")
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
        "points_per_tile": ds.max_points, "stage_ms_per_batch": stage_ms,
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
