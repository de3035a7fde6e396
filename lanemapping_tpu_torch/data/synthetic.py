"""Synthetic WHU-Lane-format tiles for tests, dry-runs and benchmarking (a
copy of `lanemapping_tpu/data/synthetic.py`).

The WHU-Lane dataset is not vendored with the reference repo; this module
fabricates statistically similar tiles — a dark BEV intensity image with a
handful of bright, mostly-vertical lane polylines — and writes them in the
exact directory layout the datasets expect
(reference `baseline/datasets/laserlane_proposals.py:40-52`):

    root/cropped_tiff/<stem>.png
    root/labels/sparse_{seq,semantic,instance,orient,endp}/<stem>.*
    root/data_split-shuffle.json
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from .label_gen import (NpEncoder, render_labels, select_and_order_lanes,
                        seq_sidecar, rasterize_polyline)


def random_lane_seqs(rng: np.random.RandomState, img: int = 1152,
                     n_lanes: int = 5) -> List[np.ndarray]:
    """Smooth near-vertical polylines spanning most of the tile height."""
    seqs = []
    base_cols = np.sort(rng.uniform(0.15 * img, 0.85 * img, n_lanes))
    for c0 in base_cols:
        top = rng.uniform(0.02 * img, 0.15 * img)
        bot = rng.uniform(0.85 * img, 0.98 * img)
        n_v = rng.randint(8, 16)
        rows = np.linspace(top, bot, n_v)
        drift = rng.uniform(-0.1, 0.1) * img
        wiggle = rng.uniform(0.0, 0.02) * img
        cols = (c0 + drift * (rows - top) / (bot - top)
                + wiggle * np.sin(rows / img * np.pi * rng.uniform(1, 3)))
        cols = np.clip(cols, 2, img - 3)
        seqs.append(np.stack([rows, cols], axis=1))
    return seqs


def hard_lane_seqs(rng: np.random.RandomState, img: int = 1152,
                   n_lanes: int = 5) -> List[np.ndarray]:
    """Adversarial lane geometry (VERDICT r4 #7: stress the tracker/NMS the
    way real WHU-Lane intersections do): strong curvature, varying extents,
    merging branches that share a vertex with their parent lane, and an
    occasional diagonal crossing lane."""
    seqs = []
    base_cols = np.sort(rng.uniform(0.12 * img, 0.88 * img, n_lanes))
    for c0 in base_cols:
        top = rng.uniform(0.02 * img, 0.25 * img)
        bot = rng.uniform(0.75 * img, 0.98 * img)
        n_v = rng.randint(10, 20)
        rows = np.linspace(top, bot, n_v)
        t = (rows - top) / (bot - top)
        drift = rng.uniform(-0.18, 0.18) * img
        curve = rng.uniform(-0.15, 0.15) * img  # quadratic bow
        wiggle = rng.uniform(0.0, 0.05) * img
        cols = (c0 + drift * t + curve * 2.0 * t * (1.0 - t)
                + wiggle * np.sin(t * np.pi * rng.uniform(1, 4)))
        seqs.append(np.stack([rows, np.clip(cols, 2, img - 3)], axis=1))
    if n_lanes >= 2 and rng.rand() < 0.5:
        # merging branch: starts ON a parent vertex, diverges downward
        parent = seqs[rng.randint(len(seqs))]
        k = rng.randint(1, max(2, len(parent) // 2))
        start = parent[k]
        bot = rng.uniform(0.80, 0.98) * img
        if bot - start[0] > 0.2 * img:
            rows = np.linspace(start[0], bot, rng.randint(6, 12))
            t = (rows - rows[0]) / (rows[-1] - rows[0])
            sep = rng.uniform(0.04, 0.12) * img * rng.choice([-1.0, 1.0])
            cols = start[1] + sep * t + rng.uniform(-0.03, 0.03) * img * t * t
            seqs.append(np.stack([rows, np.clip(cols, 2, img - 3)], axis=1))
    if rng.rand() < 0.4:
        # crossing lane: straight diagonal across the others
        top = rng.uniform(0.05, 0.30) * img
        bot = rng.uniform(0.70, 0.95) * img
        rows = np.linspace(top, bot, rng.randint(8, 14))
        c_a, c_b = rng.uniform(0.1 * img, 0.9 * img, 2)
        cols = c_a + (c_b - c_a) * np.linspace(0.0, 1.0, len(rows))
        seqs.append(np.stack([rows, np.clip(cols, 2, img - 3)], axis=1))
    return seqs


def _densify(seq: np.ndarray, step: float = 1.0) -> np.ndarray:
    """Resample a [V,2] polyline at ~``step``-px arc-length spacing."""
    d = np.hypot(*np.diff(seq, axis=0).T)
    arc = np.concatenate([[0.0], np.cumsum(d)])
    n = max(2, int(arc[-1] / step))
    t = np.linspace(0.0, arc[-1], n)
    return np.stack([np.interp(t, arc, seq[:, 0]),
                     np.interp(t, arc, seq[:, 1])], axis=1), t


def _runs_to_pieces(dense: np.ndarray, keep: np.ndarray) -> List[np.ndarray]:
    """Split an arc-length-dense polyline into kept runs."""
    pieces, run = [], []
    for p, k in zip(dense, keep):
        if k:
            run.append(p)
        elif run:
            pieces.append(np.asarray(run))
            run = []
    if run:
        pieces.append(np.asarray(run))
    return pieces


def render_intensity_image(seqs, img: int = 1152,
                           rng: np.random.RandomState = None,
                           semantics=None, hard: bool = False) -> np.ndarray:
    """Grayscale-ish BEV intensity PNG: noisy ground + bright lane marks.

    When ``semantics`` is given, dashed lanes (class 2) render as dash/gap
    segments (~3 m dash / 3 m gap at 0.05 m/px), like real road paint —
    without this the solid/dashed class is unlearnable from the image and
    semantic F1 caps near 0.5 regardless of training.  Labels stay
    continuous polylines either way (matching WHU-Lane's annotation style).

    ``hard`` (VERDICT r4 #7) adds the degradations real MLS intensity BEVs
    show: per-lane dash-density variation, along-lane paint-wear dropout,
    and dark occlusion patches (parked vehicles / scan shadows) that
    erase marks while the labels stay complete.
    """
    rng = rng or np.random.RandomState(0)
    ground = rng.normal(60, 15, (img, img)).clip(0, 255)
    marks = np.zeros((img, img), dtype=np.float64)
    for i, s in enumerate(seqs):
        dashed = semantics is not None and int(semantics[i]) == 2
        if dashed:
            dense, arc = _densify(np.asarray(s, np.float64), step=1.0)
            if hard:  # dash-density variation per lane
                period = rng.uniform(80.0, 200.0)
                duty = period * rng.uniform(0.3, 0.7)
            else:
                period, duty = 120.0, 60.0  # px: 3 m dash, 3 m gap
            phase = rng.uniform(0, period)
            keep = ((arc + phase) % period) < duty
            pieces = _runs_to_pieces(dense, keep)
        elif hard:
            # paint-wear dropout on solid lanes: drop 10-30% of the arc in
            # smooth runs (a sine gate keeps the drops contiguous)
            dense, arc = _densify(np.asarray(s, np.float64), step=1.0)
            gate = np.sin(arc / rng.uniform(40.0, 120.0)
                          + rng.uniform(0, 2 * np.pi))
            keep = gate > rng.uniform(-0.8, -0.4)
            pieces = _runs_to_pieces(dense, keep)
        else:
            pieces = [np.asarray(s, np.float64)]
        for piece in pieces:
            if len(piece) < 2:
                continue
            for d in (-1, 0, 1):  # ~3 px wide marks
                shifted = piece.copy()
                shifted[:, 1] = np.clip(shifted[:, 1] + d, 0, img - 1)
                rasterize_polyline(marks, shifted, 1.0)
    if hard:
        # occlusion patches: erase marks and darken the ground beneath
        for _ in range(rng.randint(1, 4)):
            ph = rng.randint(img // 24, img // 6)
            pw = rng.randint(img // 24, img // 8)
            r0 = rng.randint(0, img - ph)
            c0 = rng.randint(0, img - pw)
            marks[r0:r0 + ph, c0:c0 + pw] = 0.0
            ground[r0:r0 + ph, c0:c0 + pw] = rng.normal(
                35, 8, (ph, pw)).clip(0, 255)
    intensity = np.where(marks > 0, rng.normal(220, 15, (img, img)), ground)
    if hard:  # sensor intensity speckle
        intensity = intensity + rng.normal(0, 6, (img, img))
    intensity = intensity.clip(0, 255).astype(np.uint8)
    return np.stack([intensity] * 3, axis=-1)  # 3-channel like cropped_tiff


def write_transform_params(path: str, stem: str,
                           rng: np.random.RandomState) -> None:
    """Per-tile BEV<->LiDAR transform txt in the reference's line-pair
    format (`baseline/utils/io_utils.py:125-150`)."""
    tx, ty = rng.uniform(-50, 50, 2)
    lines = [
        "coor_las_path:", f"/data/las/{stem}.las",
        "las_read_offset:", "100.0 200.0 10.0",
        "las_rotation_trans_quan:", f"{tx:.3f} {ty:.3f} 0.0 1.0 0.0 0.0 0.0",
        "bev_img_offset:", "0.0 0.0",
        "img_reso:", "0.05 0.05",
        "local_min_ele:", "5.0",
        "ele_reso:", "0.1",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def lane_structured_points(seqs, semantics, img: int,
                           rng: np.random.RandomState, n_pts: int,
                           pc_range=(-15.0, -25.0, -2.0, 15.0, 25.0, 2.0),
                           lane_frac: float = 0.15) -> np.ndarray:
    """MLS-like [N,4] cloud CONSISTENT with the tile's BEV labels: mostly
    low-intensity ground returns plus bright road-paint returns sampled
    along the lane polylines (dash/gap segments for class-2 lanes, like
    `render_intensity_image`).

    The label pixel -> world mapping inverts the LidarEncoder's frame
    convention (`models/lidar_encoder.py`: voxel grid [Y,X] then a row
    flip to the annotation frame): label row 0 maps to y = y_max, label
    col 0 to x = x_min.  A model trained on these clouds can only reach
    high F1 if that alignment is right, so the synthetic LiDAR training
    run doubles as a frame-convention check.
    """
    x0, y0, z0, x1, y1, z1 = pc_range

    def rc_to_xy(rows, cols):
        x = x0 + (cols / img) * (x1 - x0)
        y = y1 - (rows / img) * (y1 - y0)
        return x, y

    n_lane = int(n_pts * lane_frac)
    pieces = []
    for i, s in enumerate(seqs):
        dense, arc = _densify(np.asarray(s, np.float64), step=1.0)
        if semantics is not None and int(semantics[i]) == 2:
            # dash/gap paint, scaled with tile size like the image render
            period = 120.0 * img / 1152.0
            keep = ((arc + rng.uniform(0, period)) % period) < (period / 2)
            dense = dense[keep]
        if len(dense):
            pieces.append(dense)
    if pieces and n_lane:
        paint = np.concatenate(pieces, axis=0)
        take = rng.randint(0, len(paint), n_lane)
        rows = paint[take, 0] + rng.normal(0.0, 0.7, n_lane)
        cols = paint[take, 1] + rng.normal(0.0, 1.2, n_lane)  # ~3 px marks
        lx, ly = rc_to_xy(np.clip(rows, 0, img - 1),
                          np.clip(cols, 0, img - 1))
        lane_pts = np.stack([
            lx, ly,
            rng.normal(0.0, 0.05, n_lane),            # paint sits on ground
            rng.normal(26000.0, 2500.0, n_lane),      # bright returns
        ], axis=1)
    else:
        lane_pts = np.zeros((0, 4))
        n_lane = 0
    n_ground = n_pts - n_lane
    n_clutter = int(n_ground * 0.03)
    n_ground -= n_clutter
    ground = np.stack([
        rng.uniform(x0, x1, n_ground),
        rng.uniform(y0, y1, n_ground),
        rng.normal(0.0, 0.12, n_ground),
        rng.normal(3000.0, 900.0, n_ground),          # asphalt returns
    ], axis=1)
    clutter = np.stack([                               # poles/vehicles/noise
        rng.uniform(x0, x1, n_clutter),
        rng.uniform(y0, y1, n_clutter),
        rng.uniform(z0, z1, n_clutter),
        rng.uniform(900.0, 30000.0, n_clutter),
    ], axis=1)
    pts = np.concatenate([lane_pts, ground, clutter], axis=0)
    pts[:, 3] = np.clip(pts[:, 3], 810.0, 32000.0)
    return pts[rng.permutation(len(pts))]


def add_structured_las(root: str, points_per_tile: int = 1 << 19,
                       seed: int = 0, stems=None) -> int:
    """Add a ``las/`` directory of lane-structured clouds to an EXISTING
    synthetic dataset root, rebuilt from the saved sparse_seq sidecars —
    so the raw-LiDAR configs (`LaserLaneProposalEgo`) can train on the
    same tiles, labels and splits as the BEV image configs."""
    from PIL import Image
    from .las import write_las_points

    seq_dir = os.path.join(root, "labels", "sparse_seq")
    las_dir = os.path.join(root, "las")
    os.makedirs(las_dir, exist_ok=True)
    if stems is None:
        stems = sorted(f[:-5] for f in os.listdir(seq_dir)
                       if f.endswith(".json"))
    rng = np.random.RandomState(seed)
    n_done = 0
    for stem in stems:
        out = os.path.join(las_dir, stem + ".las")
        if os.path.isfile(out):
            continue
        with open(os.path.join(seq_dir, stem + ".json")) as f:
            recs = json.load(f)
        seqs = [np.asarray(r["seq"], np.float64) for r in recs]
        semantics = [int(r["semantic"]) for r in recs]
        img = Image.open(os.path.join(root, "labels", "sparse_semantic",
                                      stem + ".png")).size[0]
        pts = lane_structured_points(seqs, semantics, img, rng,
                                     points_per_tile)
        write_las_points(out, pts)
        n_done += 1
    return n_done


def generate_dataset(root: str, n_tiles: int = 8, img: int = 1152,
                     n_lanes_range=(3, 7), seed: int = 0,
                     splits=None, with_params: bool = False,
                     with_points: bool = False,
                     points_per_tile: int = 20000,
                     hard: bool = False) -> List[str]:
    """Write ``n_tiles`` synthetic tiles + labels + split file under ``root``.

    ``hard=False`` is byte-stable across releases (the benchmark set);
    ``hard=True`` switches to `hard_lane_seqs` geometry (curves, merges,
    crossings) and the degraded intensity render (dropout, occlusion,
    dash-density variation) — the adversarial soak set."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "cropped_tiff")
    lbl_root = os.path.join(root, "labels")
    dirs = {k: os.path.join(lbl_root, f"sparse_{k}")
            for k in ("seq", "semantic", "instance", "orient", "endp")}
    os.makedirs(img_dir, exist_ok=True)
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    stems = []
    for i in range(n_tiles):
        stem = f"{190000 + i:06d}_{i:04d}"
        stems.append(stem)
        n_lanes = rng.randint(*n_lanes_range)
        seqs = (hard_lane_seqs if hard else random_lane_seqs)(
            rng, img, n_lanes)
        semantics = [int(rng.randint(1, 3)) for _ in seqs]
        seqs, semantics, orients = select_and_order_lanes(
            seqs, semantics, top_k=20, col_range=(0, img))
        maps = render_labels(seqs, semantics, orients, img, img)
        Image.fromarray(render_intensity_image(
            seqs, img, rng, semantics=semantics, hard=hard)).save(
            os.path.join(img_dir, stem + ".png"))
        Image.fromarray(maps["semantic"]).save(
            os.path.join(dirs["semantic"], stem + ".png"))
        Image.fromarray(maps["instance"]).save(
            os.path.join(dirs["instance"], stem + ".png"))
        Image.fromarray(maps["orient"]).save(
            os.path.join(dirs["orient"], stem + ".png"))
        Image.fromarray(maps["endp"].astype(np.uint8)).save(
            os.path.join(dirs["endp"], stem + ".png"))
        with open(os.path.join(dirs["seq"], stem + ".json"), "w") as f:
            json.dump(seq_sidecar(seqs, semantics, orients), f, cls=NpEncoder)
        if with_params:
            pdir = os.path.join(root, "cropped_tiff_param")
            os.makedirs(pdir, exist_ok=True)
            write_transform_params(os.path.join(pdir, stem + ".txt"), stem,
                                   rng)
        if with_points:
            from .las import write_las_points
            pdir = os.path.join(root, "las")
            os.makedirs(pdir, exist_ok=True)
            pts = lane_structured_points(seqs, semantics, img, rng,
                                         points_per_tile)
            write_las_points(os.path.join(pdir, stem + ".las"), pts)

    if splits is None:
        n_tr = max(1, int(0.6 * n_tiles))
        n_va = max(1, (n_tiles - n_tr) // 2)
        splits = {
            "train": stems[:n_tr],
            "valid": stems[n_tr:n_tr + n_va],
            "test": stems[n_tr + n_va:] or stems[-1:],
            "single": stems[:1],
            "pretrain": stems,
        }
    with open(os.path.join(root, "data_split-shuffle.json"), "w") as f:
        json.dump(splits, f)
    return stems
