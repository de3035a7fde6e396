"""The benchmark's inputs, drawn on the device from the run's seed: point
clouds of a mobile-laser-scanning survey, the LAS files that hold them, and
the training batches with their labels.

Every draw takes a ``torch.Generator`` on the card and makes a whole set
in a few large calls, so set-up stays short and the same seed gives the
same inputs.  Every seed gives the same sizes: the seed moves values, never
shapes or counts.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Sequence

import numpy as np
import torch

# the point-cloud range of both shipped configs (x0, y0, z0, x1, y1, z1)
PC_RANGE = (-15.0, -25.0, -2.0, 15.0, 25.0, 2.0)


def generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for one named stream of draws: the seed
    and the stream together pick it, so two streams never share draws."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + int(stream)) % (2 ** 63 - 1))


def _u(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def survey_clouds(n_clouds: int, n_points: int, img: int, seed: int,
                  device: torch.device, n_lanes: int = 5,
                  pc_range: Sequence[float] = PC_RANGE) -> torch.Tensor:
    """[n_clouds, n_points, 4] float32 (x, y, z, raw LAS intensity): road
    surface, painted lane markings and clutter, as a survey tile holds them.

    Per cloud, 15% of the points are bright paint along ``n_lanes`` smooth
    near-vertical lanes (half of them dashed, 60 px on and 60 px off at 5
    cm/px), 82% asphalt returns over the whole tile and 3% clutter
    (poles, vehicles) over the whole height; the points come in a random
    order.  The lane geometry and intensity model are those of the
    program's synthetic LaserLane tiles."""
    g = generator(device, seed, 1)
    x0, y0, z0, x1, y1, z1 = pc_range
    C, N, L = n_clouds, n_points, n_lanes
    n_lane = int(N * 0.15)
    n_clutter = int((N - n_lane) * 0.03)
    n_ground = N - n_lane - n_clutter

    def lane(shape_lo_hi):
        return _u(g, (C, L), *shape_lo_hi, device)

    c0 = lane((0.15 * img, 0.85 * img))
    top = lane((0.02 * img, 0.15 * img))
    bot = lane((0.85 * img, 0.98 * img))
    drift = lane((-0.1 * img, 0.1 * img))
    wiggle = lane((0.0, 0.02 * img))
    freq = lane((1.0, 3.0))
    dashed = torch.rand((C, L), generator=g, device=device) < 0.5
    phase = lane((0.0, 120.0))
    # paint: a lane per point, a row along it, on the dash where dashed
    li = torch.randint(0, L, (C, n_lane), generator=g, device=device)

    def at(v):
        return torch.gather(v, 1, li)

    t, b = at(top), at(bot)
    rows = t + (b - t) * torch.rand((C, n_lane), generator=g, device=device)
    gap = ((rows - t + at(phase)) % 120.0) >= 60.0
    rows = torch.where(at(dashed) & gap, torch.clamp(rows + 60.0, max=b),
                       rows)
    cols = (at(c0) + at(drift) * (rows - t) / (b - t)
            + at(wiggle) * torch.sin(rows / img * np.pi * at(freq)))
    rows = rows + 0.7 * torch.randn(rows.shape, generator=g, device=device)
    cols = cols + 1.2 * torch.randn(cols.shape, generator=g, device=device)
    rows = rows.clamp(0, img - 1)
    cols = cols.clamp(0, img - 1)
    paint = torch.stack([
        x0 + cols / img * (x1 - x0), y1 - rows / img * (y1 - y0),
        0.05 * torch.randn(rows.shape, generator=g, device=device),
        26000.0 + 2500.0 * torch.randn(rows.shape, generator=g,
                                       device=device)], -1)
    ground = torch.stack([
        _u(g, (C, n_ground), x0, x1, device),
        _u(g, (C, n_ground), y0, y1, device),
        0.12 * torch.randn((C, n_ground), generator=g, device=device),
        3000.0 + 900.0 * torch.randn((C, n_ground), generator=g,
                                     device=device)], -1)
    clutter = torch.stack([
        _u(g, (C, n_clutter), x0, x1, device),
        _u(g, (C, n_clutter), y0, y1, device),
        _u(g, (C, n_clutter), z0, z1, device),
        _u(g, (C, n_clutter), 900.0, 30000.0, device)], -1)
    pts = torch.cat([paint, ground, clutter], 1)
    pts[..., 3].clamp_(810.0, 32000.0)
    order = torch.argsort(torch.rand((C, N), generator=g, device=device), 1)
    return torch.gather(pts, 1, order[..., None].expand(C, N, 4)).contiguous()


def write_las(path: str, pts: np.ndarray, scale: float = 0.001) -> None:
    """A LAS 1.2 file of point format 0 (20-byte records: x, y, z as
    scaled int32 from the cloud's minimum, intensity as uint16), as
    surveys export them."""
    pts = np.asarray(pts, np.float64)
    n = len(pts)
    offset = pts[:, :3].min(axis=0)
    header = bytearray(227)
    header[0:4] = b"LASF"
    struct.pack_into("<BB", header, 24, 1, 2)
    struct.pack_into("<H", header, 94, 227)
    struct.pack_into("<I", header, 96, 227)
    struct.pack_into("<B", header, 104, 0)
    struct.pack_into("<H", header, 105, 20)
    struct.pack_into("<I", header, 107, n)
    struct.pack_into("<3d", header, 131, scale, scale, scale)
    struct.pack_into("<3d", header, 155, *offset)
    rec = np.zeros((n, 20), np.uint8)
    xyz = np.round((pts[:, :3] - offset) / scale).astype("<i4")
    rec[:, :12] = xyz.view(np.uint8).reshape(n, 12)
    rec[:, 12:14] = pts[:, 3].astype("<u2").view(np.uint8).reshape(n, 2)
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(rec.tobytes())


def write_survey(root: str, clouds: torch.Tensor) -> List[str]:
    """One ``<root>/las/<stem>.las`` per cloud; returns the stems."""
    las_dir = os.path.join(root, "las")
    os.makedirs(las_dir, exist_ok=True)
    host = clouds.cpu().numpy()
    stems = [f"tile{i:04d}" for i in range(len(host))]
    for stem, pts in zip(stems, host):
        write_las(os.path.join(las_dir, stem + ".las"), pts)
    return stems


def read_las(path: str) -> np.ndarray:
    """[N, 4] float64 (x, y, z, intensity normalised as the survey
    pipeline does: clipped to [800, 33000], minus 800, over 33000) of a
    point-format-0 file that ``write_las`` wrote."""
    with open(path, "rb") as f:
        header = f.read(227)
        n = struct.unpack_from("<I", header, 107)[0]
        scale = np.array(struct.unpack_from("<3d", header, 131))
        offset = np.array(struct.unpack_from("<3d", header, 155))
        rec = np.frombuffer(f.read(n * 20), np.uint8).reshape(n, 20)
    out = np.empty((n, 4), np.float64)
    out[:, :3] = rec[:, :12].copy().view("<i4").reshape(n, 3) * scale \
        + offset
    out[:, 3] = (np.clip(rec[:, 12:14].copy().view("<u2").reshape(n),
                         800.0, 33000.0) - 800.0) / 33000.0
    return out


def train_batches(cfg, n_batches: int, batch: int, seed: int,
                  device: torch.device, clouds: torch.Tensor = None
                  ) -> List[Dict[str, torch.Tensor]]:
    """``n_batches`` distinct training batches of ``batch`` tiles on the
    device, by the recipe of the program's training benchmark: a uniform
    tile (or, on a LiDAR config, the clouds given, intensity
    normalised), proposal labels, a sparse endpoint map and the fused
    segmentation focal loss's instance map.  Labels are drawn, not built:
    they are inputs handed alike to the program and the reference."""
    g = generator(device, seed, 2)
    img = cfg["list_img_size_xy"][0]
    h = cfg["heads"]
    S, P = h["row_size"], h["num_prop"]
    W = h["prop_width"] + 2 * h["prop_half_buff"]
    B = batch
    # the tile and the endpoint map ship in bf16 under bf16 training
    bf16 = torch.bfloat16 if cfg.get("train_compute_dtype") == "bfloat16" \
        else torch.float32

    def ri(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=g,
                             device=device).to(dtype)

    def rf(shape):
        return torch.rand(shape, generator=g, device=device)

    out = []
    for i in range(n_batches):
        if cfg.get("use_lidar", False):
            pts = clouds[i * B:(i + 1) * B].clone()
            pts[..., 3] = (pts[..., 3].clamp(800.0, 33000.0) - 800.0) \
                / 33000.0
            inp = {"points": pts,
                   "points_mask": torch.ones(pts.shape[:2], dtype=torch.bool,
                                             device=device)}
        else:
            inp = {"proj": rf((B, img, img, 3)).to(bf16)}
        endp = rf((B, img, img))
        b = {
            **inp,
            "prop_ext": ri(0, 3, (B, P, S), torch.uint8),
            "prop_coor": -1.0 + (W + 1.0) * rf((B, P, S)),
            "prop_offset": torch.randn((B, P, S, W), generator=g,
                                       device=device),
            "prop_offset_mask": ri(0, 2, (B, P, S, W), torch.float32),
            "lc_orient": ri(0, 11, (B, S, S), torch.uint8),
            "semantic_label_raw": ri(0, 3, (B, img, img), torch.uint8),
            "endp_map": torch.where(rf((B, img, img)) > 0.999, endp,
                                    torch.zeros_like(endp)).to(bf16),
            "prop_inst": torch.where(rf((B, img, img)) < 0.01,
                                     ri(0, 12, (B, img, img), torch.uint8),
                                     torch.full((), 255, dtype=torch.uint8,
                                                device=device)),
            "prop_best": ri(0, 12, (B, P), torch.uint8),
        }
        out.append(b)
    return out
