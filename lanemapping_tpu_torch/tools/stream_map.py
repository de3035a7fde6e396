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
        [--params-dir <data_root>/cropped_tiff_param] [--device cuda]

One ``<out>/lanes_2d/<name>.json`` is written per tile.  Without ``--ckpt``
the weights are random, drawn from ``--seed`` (default ``cfg.seed``).
With ``--params-dir`` (a ``cropped_tiff_param`` directory) the lanes are
then lifted to the LiDAR frame, with the elevations of
``<data_root>/cropped_tiff`` (`tools/img2pc.py`, 8 worker processes), and
merged into one global map (`tools/merge_lines.py`), as the JAX script
does (`tools/stream_map.py:325-335` there).

Data-parallel serving (JAX `tools/stream_map.py:162-199`): one model
replica per device of the config's mesh (`parallel/mesh.py::make_mesh`;
``--device cuda`` means every card the config's ``mesh_shape`` takes, the
flagship's ``data=-1`` every local card), in one process.  Each batch is
split by rows over the replicas, each runs its rows on its own device (the
``--from-las`` rasterize, K1, included) and the decodes come back in tile
order.  A ragged final batch is padded to the full batch and the padded
tiles discarded; a batch that does not divide over the replicas is
refused.  With one device it runs as a single replica, unpadded.
``main(argv, devices=[...])`` takes the mesh's devices explicitly (two
replicas on one card, or on the CPU).

``main`` returns the run's numbers: tiles/s, and per stage the milliseconds
per batch (device time from CUDA events for upload, the input stage
(rasterize, voxelize or normalize), forward and decode, summed over the
replicas; host time for the postprocess workers); after a 3-D lift also
the paths of the 3-D lane directory and of the merged and down-sampled
maps, and the lift's wall seconds (outside the timed region).
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# the device stages of each input path, in order
STAGES = {"las": ("upload", "rasterize", "forward", "decode"),
          "lidar": ("upload", "voxelize", "forward", "decode"),
          "image": ("upload", "normalize", "forward", "decode")}


class StageClock:
    """Per-stage device time: CUDA events on the cards, host clock on the
    CPU (where every op is synchronous)."""

    def __init__(self, devices: Sequence[torch.device]):
        self.cuda = devices[0].type == "cuda"
        self.cards = sorted({d for d in devices if d.type == "cuda"},
                            key=str)
        self.marks: List[tuple] = []  # (stage, start, end)

    def now(self, device: Optional[torch.device] = None):
        """A mark on ``device``'s current stream (the current device's by
        default)."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
            return ev
        return time.perf_counter()

    def add(self, stage: str, start, end):
        self.marks.append((stage, start, end))

    def synchronize(self):
        for d in self.cards:
            torch.cuda.synchronize(d)

    def ms_per_stage(self, n_batches: int) -> Dict[str, float]:
        """Per stage, the milliseconds of all its marks over ``n_batches``
        (a batch's replicas summed)."""
        self.synchronize()
        tot: Dict[str, float] = {}
        for stage, a, b in self.marks:
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            tot[stage] = tot.get(stage, 0.0) + ms
        return {s: v / n_batches for s, v in tot.items()}


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
    ap.add_argument("--params-dir", default=None,
                    help="cropped_tiff_param dir for the 3-D lift; skipped "
                    "if absent")
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


def main(argv=None, devices: Optional[Sequence] = None) -> Dict:
    args = parse_args(argv)
    from ..api import load_checkpoint, resolve_device
    from ..config.config import Config, parse_dict_action
    from ..data.las_tiles import LasTiles
    from ..data.loader import Loader
    from ..decode.lane_decode import decode_lanes, host_decode_view
    from ..decode.postprocess import lane_maps_from_decode
    from ..models.nets import build_model, round_weights_as_flax_promotes
    from ..ops.voxelize import bev_image_from_points
    from ..parallel.mesh import make_mesh, row_slice
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
    mesh = make_mesh(cfg, devices, device)
    n_rep = len(mesh)
    if n_rep > 1:
        if cfg.batch_size % n_rep:
            raise SystemExit(f"[stream_map] --batch {cfg.batch_size} must "
                             f"divide over {n_rep} devices")
        print(f"[stream_map] data-parallel over {n_rep} devices: "
              f"{[str(d) for d in mesh]}")

    model = build_model(cfg, seed=cfg.get("seed", 0)
                        if args.seed is None else args.seed)
    if args.ckpt:
        load_checkpoint(model, args.ckpt)
    bf16 = cfg.get("compute_dtype") == "bfloat16"
    dtype = torch.bfloat16 if bf16 and not use_lidar else torch.float32
    if bf16 and use_lidar:
        round_weights_as_flax_promotes(model)
    replicas = []
    for dev in mesh:
        rep = copy.deepcopy(model) if replicas else model
        rep = rep.to(device=dev, dtype=dtype)
        if dev.type == "cuda":
            rep = rep.to(memory_format=torch.channels_last)
        replicas.append((dev, rep))

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
    clock = StageClock(mesh)
    voxelized = []  # the clock mark at the end of the LiDAR voxelize stage
    if kind == "lidar":
        for dev, rep in replicas:
            rep.pcencoder.zfold_encoder.register_forward_pre_hook(
                lambda module, inputs, dev=dev: voxelized.append(
                    clock.now(dev)))

    def fwd_dec(batch, timed: bool):
        """One batch on the mesh: each replica's rows through upload, input
        stage, forward and decode on its device; [(rows' decode, on the
        device)] in replica order.  With more than one replica a ragged
        batch is padded with zeros to the full batch first."""
        if kind == "image":
            host = (to_u8(batch["proj"]),)
        else:
            host = (np.asarray(batch["points"], np.float32),
                    np.asarray(batch["points_mask"], bool))
        if n_rep > 1 and len(host[0]) < cfg.batch_size:
            host = tuple(np.concatenate([a, np.zeros(
                (cfg.batch_size - len(a),) + a.shape[1:], a.dtype)])
                for a in host)
        return [rows_fwd_dec(dev, rep, [np.ascontiguousarray(
            a[row_slice(i, n_rep, len(a))]) for a in host], timed)
            for i, (dev, rep) in enumerate(replicas)]

    def rows_fwd_dec(device, model, host, timed: bool):
        t = [clock.now(device)]
        dev = [torch.from_numpy(a).to(device) for a in host]
        t.append(clock.now(device))
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
                t.append(clock.now(device))
                out = model(x)
            t.append(clock.now(device))
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
            t.append(clock.now(device))
        if timed:
            for stage, a, b in zip(STAGES[kind], t[:-1], t[1:]):
                clock.add(stage, a, b)
        return keep

    def postprocess(decs, names):
        """Readback of every replica's rows (in tile order, padded tiles
        dropped), then tracker/NMS/semantics and the JSONs, on a worker.
        Returns (lane arc length px, readback s, host postprocess s)."""
        t0 = time.perf_counter()
        dec = {k: np.concatenate([d[k].cpu().numpy() for d in decs])[
            :len(names)] for k in decs[0]}
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
    clock.synchronize()

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
    stage_ms = clock.ms_per_stage(n_batches)
    stage_ms["postprocess_host"] = \
        float(np.mean([r[2] for r in results])) * 1e3
    stage_ms["readback"] = float(np.mean([r[1] for r in results])) * 1e3
    lane_px = sum(r[0] for r in results)
    tiles_s = n_tiles / max(wall, 1e-9)
    km_lane_h = lane_px * cfg.get("img_reso", 0.05) / 1000.0 \
        / max(wall, 1e-9) * 3600.0
    rec = {
        "metric": "e2e_tiles_per_sec", "value": tiles_s, "unit": "tiles/s",
        "device": str(device), "devices": [str(d) for d in mesh],
        "n_tiles": n_tiles, "n_batches": n_batches,
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
    if args.params_dir and os.path.isdir(args.params_dir):
        from .img2pc import convert_directory
        from .merge_lines import merge_directory
        t0 = time.perf_counter()
        pc_dir = convert_directory(
            lanes_dir, os.path.join(args.data_root, "cropped_tiff"),
            args.params_dir, n_workers=8)
        rec["merged_map"], rec["merged_downsample"] = merge_directory(pc_dir)
        rec["pc_dir"] = pc_dir
        rec["lift_s"] = time.perf_counter() - t0
        print(f"[stream_map] global map: {rec['merged_map']}")
    else:
        print("[stream_map] no params dir: stopping at 2-D lane seqs")
    if args.bench_json:
        print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
