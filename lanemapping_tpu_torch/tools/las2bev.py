"""Offline Las2BEV: raw ``.las`` survey tiles -> BEV intensity PNGs, on the
card.

Port of `lanemapping_tpu/tools/las2bev.py`: ``las2bev_params`` is copied,
and ``convert_las_directory`` runs the rasterize + hole-fill +
intensity-calibration pipeline (`ops/voxelize.py::bev_image_from_points`,
on the K1 binning kernel) batched on ``device`` (the card unless the caller
asks for the CPU) and writes tiles in the ``cropped_tiff`` layout the image
datasets load.

For streaming inference the PNG intermediate is not needed:
`tools/stream_map.py --from-las` runs the same rasterization in front of
the network.

The command line takes the JAX script's arguments (`tools/las2bev.py`
there) and ``--device`` (the card unless ``--device cpu``), and prints the
same JSON stats without the list of written files:

    python -m lanemapping_tpu_torch.tools.las2bev <las_dir> <out_dir> \
        [--img 1152] [--pc-range X0 Y0 Z0 X1 Y1 Z1] [--gain G] [--bias B] \
        [--fill-iters 6] [--max-points 524288] [--batch 4] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time
from glob import glob
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

DEFAULT_PC_RANGE = (-15.0, -25.0, -2.0, 15.0, 25.0, 2.0)
DEFAULT_GAIN = 0.900
DEFAULT_BIAS = 0.1535


def las2bev_params(cfg=None) -> Dict:
    """Las2BEV knobs from a config's ``las2bev`` dict (all optional):
    ``pc_range``, ``gain``, ``bias``, ``fill_iters``.  The gain/bias defaults
    are calibrated to the synthetic MLS intensity model; calibrate per
    sensor for real surveys."""
    p = dict(cfg.get("las2bev", {})) if cfg is not None else {}
    p.setdefault("pc_range", cfg.get("lidar_point_cloud_range",
                                     DEFAULT_PC_RANGE)
                 if cfg is not None else DEFAULT_PC_RANGE)
    p.setdefault("gain", DEFAULT_GAIN)
    p.setdefault("bias", DEFAULT_BIAS)
    p.setdefault("fill_iters", 6)
    return p


def convert_las_directory(las_dir: str, out_dir: str, img: int = 1152,
                          pc_range: Sequence[float] = DEFAULT_PC_RANGE,
                          gain: float = DEFAULT_GAIN,
                          bias: float = DEFAULT_BIAS,
                          fill_iters: int = 6,
                          max_points: int = 1 << 19,
                          batch: int = 4,
                          stems: Optional[List[str]] = None,
                          device: Union[str, torch.device] = "cuda") -> Dict:
    """Rasterize every ``.las`` under ``las_dir`` to ``out_dir/<stem>.png``
    (3 identical uint8 channels), ``batch`` clouds per call on ``device``.
    Returns throughput stats."""
    from PIL import Image

    from ..api import resolve_device
    from ..data.las import load_lidar_points, pad_points
    from ..ops.voxelize import bev_image_from_points

    device = resolve_device(device)
    if stems is None:
        stems = sorted(osp.basename(p)[:-4]
                       for p in glob(osp.join(las_dir, "*.las")))
    if not stems:
        raise FileNotFoundError(f"no .las files under {las_dir}")
    os.makedirs(out_dir, exist_ok=True)

    n_pts_total, t0 = 0, time.time()
    written = []
    for i in range(0, len(stems), batch):
        chunk = stems[i:i + batch]
        pts = np.zeros((len(chunk), max_points, 4), np.float32)
        msk = np.zeros((len(chunk), max_points), bool)
        for j, stem in enumerate(chunk):
            p = load_lidar_points(osp.join(las_dir, stem + ".las"))
            pts[j], msk[j] = pad_points(p, max_points)
            n_pts_total += min(len(p), max_points)
        with torch.inference_mode():
            x = bev_image_from_points(
                torch.from_numpy(pts).to(device),
                torch.from_numpy(msk).to(device), pc_range, img, gain=gain,
                bias=bias, fill_iters=fill_iters)
            tiles = torch.round(x * 255.0).to(torch.uint8).cpu().numpy()
        for j, stem in enumerate(chunk):
            # replicate to 3 channels: the cropped_tiff convention the image
            # datasets expect (ref `laserlane_proposals.py:85-98`)
            rgb = np.repeat(tiles[j][:, :, None], 3, axis=2)
            path = osp.join(out_dir, stem + ".png")
            Image.fromarray(rgb).save(path)
            written.append(path)
    dt = time.time() - t0
    return {"n_tiles": len(written), "n_points": n_pts_total,
            "wall_s": round(dt, 2),
            "tiles_per_sec": round(len(written) / max(dt, 1e-9), 2),
            "points_per_sec": round(n_pts_total / max(dt, 1e-9), 0),
            "out_dir": out_dir, "written": written}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("las_dir")
    ap.add_argument("out_dir", help="output PNG dir (use <root>/cropped_tiff "
                                    "to feed the image datasets)")
    ap.add_argument("--img", type=int, default=1152)
    ap.add_argument("--pc-range", type=float, nargs=6,
                    default=None, metavar=("X0", "Y0", "Z0", "X1", "Y1", "Z1"))
    ap.add_argument("--gain", type=float, default=None)
    ap.add_argument("--bias", type=float, default=None)
    ap.add_argument("--fill-iters", type=int, default=None)
    ap.add_argument("--max-points", type=int, default=1 << 19)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    p = las2bev_params()
    if args.pc_range is not None:
        p["pc_range"] = tuple(args.pc_range)
    for k in ("gain", "bias", "fill_iters"):
        if getattr(args, k) is not None:
            p[k] = getattr(args, k)
    stats = convert_las_directory(
        args.las_dir, args.out_dir, img=args.img, pc_range=p["pc_range"],
        gain=p["gain"], bias=p["bias"], fill_iters=p["fill_iters"],
        max_points=args.max_points, batch=args.batch, device=args.device)
    stats.pop("written")
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
