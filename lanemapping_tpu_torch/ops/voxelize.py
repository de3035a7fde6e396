"""Point-cloud BEV rasterization (the Las2BEV preprocess) on the card.

Port of the LAS path of `lanemapping_tpu/ops/voxelize.py`:
``rasterize_bev_intensity`` bins points into per-cell (sum, count) with the
K1 kernel (`kernels/bev_bin.py`, CUDA source `csrc/bev_bin.cu`), and
``bev_image_from_points`` adds the hole fill and the intensity calibration.
The z-fold voxelizer of the LiDAR encoder is a later slice.

Functions take a batch: points [B,N,C], mask [B,N] (a single [N,C] cloud
with an [N] mask is accepted too and keeps its unbatched shape).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..kernels.bev_bin import bev_bin_sums


def _batched(points: torch.Tensor, mask: torch.Tensor):
    if points.dim() == 2:
        return points[None], mask[None], True
    return points, mask, False


def rasterize_bev_intensity(points: torch.Tensor, mask: torch.Tensor,
                            pc_range: Sequence[float], img: int,
                            intensity_col: int = 3,
                            flip_rows: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Points -> (mean intensity, count) BEV images [B, img, img].

    Row = y bin, col = x bin; with ``flip_rows`` row 0 = y_max (the
    annotation/tile frame of the synthetic labels).  The mean is
    ``sum / max(count, 1)``, taken here and not in the kernel."""
    pts, msk, single = _batched(points, mask)
    sums, cnts = bev_bin_sums(pts.float().contiguous(), msk.contiguous(),
                              pc_range, img, intensity_col, flip_rows)
    mean = sums / torch.clamp(cnts, min=1.0)
    if single:
        return mean[0], cnts[0]
    return mean, cnts


def _box3_sum(x: torch.Tensor) -> torch.Tensor:
    """3x3 neighbourhood sum with zero padding, exact in float32: a pooling
    sum with divisor 1 (a ones-kernel convolution would go through cuDNN's
    TF32 by default and round the sums to 10 mantissa bits)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, divisor_override=1)


def fill_bev_holes(val: torch.Tensor, cnt: torch.Tensor,
                   iters: int = 6) -> torch.Tensor:
    """Fill empty BEV pixels by iterated 3x3 neighbourhood means ([B,H,W] or
    [H,W]).

    Each iteration assigns every still-empty pixel the mean of its already
    filled 3x3 neighbours; pixels that remain empty after ``iters`` keep
    ``val``'s 0 (the caller's bias maps that to the ground level)."""
    single = val.dim() == 2
    v = val[None, None] if single else val[:, None]
    filled = (cnt > 0).to(v.dtype)
    filled = filled[None, None] if single else filled[:, None]
    for _ in range(iters):
        s = _box3_sum(v * filled)
        c = _box3_sum(filled)
        grown = (c > 0).to(v.dtype)
        v = torch.where((filled == 0) & (grown > 0),
                        s / torch.clamp(c, min=1.0), v)
        filled = torch.maximum(filled, grown)
    return v[0, 0] if single else v[:, 0]


def bev_image_from_points(points: torch.Tensor, mask: torch.Tensor,
                          pc_range: Sequence[float], img: int,
                          gain: float = 0.900, bias: float = 0.1535,
                          fill_iters: int = 6) -> torch.Tensor:
    """On-device Las2BEV: [B,N,4] clouds -> [B, img, img] float BEV tiles in
    [0, 1], ready to broadcast to the flagship's 3-channel input.

    ``gain``/``bias`` map normalised LAS intensity to the tile intensity the
    network was trained on (defaults calibrated to the synthetic MLS
    intensity model, see `lanemapping_tpu/ops/voxelize.py`)."""
    mean, cnt = rasterize_bev_intensity(points, mask, pc_range, img,
                                        flip_rows=True)
    mean = fill_bev_holes(mean, cnt, iters=fill_iters)
    return torch.clamp(mean * gain + bias, 0.0, 1.0)
