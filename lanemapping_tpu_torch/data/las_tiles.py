"""Sensor-native streaming dataset: a directory of raw ``.las`` tiles.

A copy of `lanemapping_tpu/data/las_tiles.py`.

The reference's data story STARTS from ``.las`` survey tiles that an offline
Las2BEV step turns into BEV intensity PNGs (`README.md:171-172` of the
reference) before any model runs.  This dataset emits padded static point
buffers straight from disk, so the on-device Las2BEV
(`ops.voxelize.bev_image_from_points`, on the K1 binning kernel) + flagship
forward + decode run raw cloud -> lanes (`tools/stream_map.py --from-las`)
with no PNG intermediate on disk.
"""

from __future__ import annotations

import json
import os.path as osp
from glob import glob
from typing import Dict

import numpy as np

from ..registry import DATASETS
from .las import load_lidar_points, pad_points


@DATASETS.register_module(name="LasTiles")
class LasTiles:
    """List ``<root>/las/*.las`` (or ``<root>/*.las``) and emit
    ``{image_name, points, points_mask}``.  Unlike ``LaserLaneProposalEgo``
    no labels or BEV PNGs are required — this is the pure streaming-ingest
    path.  ``mode`` filters by the split file when one exists ("all" takes
    every cloud)."""

    def __init__(self, data_root: str,
                 data_split_file: str = "data_split-shuffle.json",
                 mode: str = "all", max_points=None, cfg=None):
        las_dir = data_root if glob(osp.join(data_root, "*.las")) \
            else osp.join(data_root, "las")
        stems = sorted(osp.basename(p)[:-4]
                       for p in glob(osp.join(las_dir, "*.las")))
        split_path = osp.join(data_root, data_split_file)
        if mode not in ("all", "infer_only") and osp.isfile(split_path):
            with open(split_path) as f:
                split = json.load(f)
            key = {"val": "valid"}.get(mode, mode)
            want = set(split.get(key, []))
            stems = [s for s in stems if s in want]
        if not stems:
            raise FileNotFoundError(f"no .las tiles under {las_dir}")
        self.las_dir, self.stems = las_dir, stems
        if max_points is None:
            max_points = cfg.get("max_points", 1 << 19) if cfg else 1 << 19
        self.max_points = int(max_points)

    def __len__(self) -> int:
        return len(self.stems)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        stem = self.stems[idx]
        pts, mask = pad_points(
            load_lidar_points(osp.join(self.las_dir, stem + ".las")),
            self.max_points)
        return {"image_name": stem, "points": pts, "points_mask": mask}
