"""Seeded lane-structured point clouds (the NumPy subset of
`lanemapping_tpu/data/synthetic.py` the streaming path needs).

``random_lane_seqs`` draws smooth near-vertical lane polylines in tile pixel
coordinates and ``lane_structured_points`` samples an MLS-like [N,4] cloud
(x, y, z, raw LAS intensity) consistent with them: low-intensity ground,
bright road paint along the lanes (~15% of the points), and 3% clutter.  The
streaming tools and the chip smoke test make their input with it, so nothing
is downloaded.
"""

from __future__ import annotations

from typing import List

import numpy as np


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


def _densify(seq: np.ndarray, step: float = 1.0) -> np.ndarray:
    """Resample a [V,2] polyline at ~``step``-px arc-length spacing."""
    d = np.hypot(*np.diff(seq, axis=0).T)
    arc = np.concatenate([[0.0], np.cumsum(d)])
    n = max(2, int(arc[-1] / step))
    t = np.linspace(0.0, arc[-1], n)
    return np.stack([np.interp(t, arc, seq[:, 0]),
                     np.interp(t, arc, seq[:, 1])], axis=1), t


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
