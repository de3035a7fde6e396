"""Minimal LAS point-cloud reader and writer (no laspy needed).

A copy of `lanemapping_tpu/data/las.py`.

Reads LAS 1.1-1.4 files with point formats 0-10 well enough for the lane
pipeline: x/y/z (scaled int32) + intensity (uint16), i.e. the fields consumed
by the reference's `read_las` (`laserlane_proposals.py:618-636`), including
its intensity clip to [800, 33000] and normalisation.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

INTEN_MIN = 800.0
INTEN_MAX = 33000.0


def read_las_points(path: str) -> np.ndarray:
    """[N,4] float64 (x, y, z, raw_intensity)."""
    with open(path, "rb") as f:
        header = f.read(375)
        if header[:4] != b"LASF":
            raise ValueError(f"{path}: not a LAS file")
        point_data_offset = struct.unpack_from("<I", header, 96)[0]
        fmt_id = struct.unpack_from("<B", header, 104)[0] & 0x3F
        rec_len = struct.unpack_from("<H", header, 105)[0]
        n_points = struct.unpack_from("<I", header, 107)[0]
        if n_points == 0:  # LAS 1.4 keeps the count at offset 247
            n_points = struct.unpack_from("<Q", header, 247)[0]
        sx, sy, sz = struct.unpack_from("<3d", header, 131)
        ox, oy, oz = struct.unpack_from("<3d", header, 155)
        f.seek(point_data_offset)
        raw = np.frombuffer(f.read(n_points * rec_len), dtype=np.uint8)
    raw = raw.reshape(n_points, rec_len)
    xyz_i = raw[:, :12].reshape(-1).view("<i4").reshape(n_points, 3)
    # intensity sits at byte 12 for formats 0-5, byte 12 for 6-10 as well
    inten = raw[:, 12:14].reshape(-1).view("<u2").reshape(n_points)
    out = np.empty((n_points, 4), dtype=np.float64)
    out[:, 0] = xyz_i[:, 0] * sx + ox
    out[:, 1] = xyz_i[:, 1] * sy + oy
    out[:, 2] = xyz_i[:, 2] * sz + oz
    out[:, 3] = inten
    return out


def write_las_points(path: str, pts: np.ndarray, scale: float = 0.001) -> None:
    """Minimal LAS 1.2 / point-format-0 writer (tests, synthetic tiles)."""
    pts = np.asarray(pts, dtype=np.float64)
    n = len(pts)
    offset = pts[:, :3].min(axis=0) if n else np.zeros(3)
    header = bytearray(227)
    header[0:4] = b"LASF"
    struct.pack_into("<BB", header, 24, 1, 2)  # version 1.2
    struct.pack_into("<H", header, 94, 227)    # header size
    struct.pack_into("<I", header, 96, 227)    # point data offset
    struct.pack_into("<B", header, 104, 0)     # point format 0
    struct.pack_into("<H", header, 105, 20)    # record length
    struct.pack_into("<I", header, 107, n)
    struct.pack_into("<3d", header, 131, scale, scale, scale)
    struct.pack_into("<3d", header, 155, *offset)
    rec = np.zeros((n, 20), dtype=np.uint8)
    xyz = np.round((pts[:, :3] - offset) / scale).astype("<i4")
    rec[:, :12] = xyz.view(np.uint8).reshape(n, 12)
    rec[:, 12:14] = pts[:, 3].astype("<u2").view(np.uint8).reshape(n, 2)
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(rec.tobytes())


def load_lidar_points(path: str) -> np.ndarray:
    """Reference `read_las` semantics (`laserlane_proposals.py:618-636`):
    [N,4] (x,y,z, intensity normalised via clip[800,33000]/33000)."""
    if path.endswith(".npy"):
        pts = np.load(path).astype(np.float64)
    else:
        pts = read_las_points(path)
    inten = np.clip(pts[:, 3], INTEN_MIN, INTEN_MAX)
    pts[:, 3] = (inten - INTEN_MIN) / INTEN_MAX
    return pts


def pad_points(pts: np.ndarray, max_points: int) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """Static-shape [max_points,4] buffer + validity mask (fixed shapes batch
    without ragged per-cloud lists)."""
    n = min(len(pts), max_points)
    out = np.zeros((max_points, 4), dtype=np.float32)
    out[:n] = pts[:n]
    mask = np.zeros((max_points,), dtype=bool)
    mask[:n] = True
    return out, mask
