"""Point-cloud voxelization and BEV rasterization on the card.

Port of `lanemapping_tpu/ops/voxelize.py`.  The LiDAR half:
``voxelize_bev_zfold`` bins points into per-voxel feature means in the
z-fold layout with the K1z kernel (`kernels/voxel_bin.py`, CUDA source
`csrc/voxel_bin.cu`), which writes the mean itself; ``first_k_in_voxel``
(the ``ref_exact_voxel_cap`` mode) narrows the mask beforehand with a stable
sort.  The LAS half: ``rasterize_bev_intensity`` bins points into per-cell
(mean, count) with the K1 kernel (`kernels/bev_bin.py`, CUDA source
`csrc/bev_bin.cu`), and ``bev_image_from_points`` adds the hole fill and the
intensity calibration.

Functions take a batch: points [B,N,C], mask [B,N] (a single [N,C] cloud
with an [N] mask is accepted too and keeps its unbatched shape).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..kernels.bev_bin import bev_bin_mean
from ..kernels.voxel_bin import voxel_bin_mean, voxel_cells


def _batched(points: torch.Tensor, mask: torch.Tensor):
    if points.dim() == 2:
        return points[None], mask[None], True
    return points, mask, False


def point_voxel_ids(points: torch.Tensor, pc_range: Sequence[float],
                    grid: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear voxel id (int64, z-major, then y, x, as the JAX package) per
    point and an in-range mask: [B,N,>=3] -> ([B,N], [B,N]) (or [N] for an
    [N,C] cloud).  Out-of-range points get the id of their cell clipped into
    the grid.  ``grid`` = (X, Y, Z); ``pc_range`` = (x0, y0, z0, x1, y1,
    z1)."""
    X, Y, _ = grid
    ijk, valid = voxel_cells(points, pc_range, grid)
    return (ijk[..., 2] * Y + ijk[..., 1]) * X + ijk[..., 0], valid


def first_k_in_voxel(lin: torch.Tensor, valid: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Mask of the valid points that are among the first ``k`` (in point
    order) of their voxel, per row of [B,N] (or [N]) ids — mmdet3d's hard
    voxelizer ``max_num_points`` cap.  A stable sort by voxel id keeps point
    order within a voxel, so rank-in-voxel = position - segment start (a
    running max of the segment starts)."""
    sentinel = torch.iinfo(torch.int64).max
    key = torch.where(valid, lin, torch.full_like(lin, sentinel))
    sk, order = torch.sort(key, dim=-1, stable=True)
    pos = torch.arange(key.shape[-1], device=key.device).expand_as(key)
    is_first = torch.ones_like(valid)
    is_first[..., 1:] = sk[..., 1:] != sk[..., :-1]
    seg_start = torch.cummax(torch.where(is_first, pos, torch.zeros_like(pos)),
                             dim=-1).values
    keep = torch.zeros_like(valid).scatter_(-1, order, (pos - seg_start) < k)
    # invalid points share the sentinel key and would keep their first k
    return valid & keep


def voxelize_bev_zfold(points: torch.Tensor, mask: torch.Tensor,
                       pc_range: Sequence[float], grid: Sequence[int],
                       max_points_per_voxel: Optional[int] = None
                       ) -> torch.Tensor:
    """Z-folded BEV feature plane of per-voxel feature means: [B,N,C]
    points -> [B, Y, X, Z*C] float32 (an [N,C] cloud -> [Y, X, Z*C]).

    ``mask`` marks real points.  Voxelization runs in float32 whatever the
    points' dtype.  ``max_points_per_voxel`` (cfg ``ref_exact_voxel_cap``)
    averages only the first K points of each voxel; None averages all.  The
    [B,Y,X,Z*C] result is the channels-last layout of an NCHW
    [B, Z*C, Y, X] tensor, so ``.permute(0, 3, 1, 2)`` feeds a convolution
    with no copy."""
    pts, msk, single = _batched(points, mask)
    pts = pts.float().contiguous()
    if max_points_per_voxel is not None:
        lin, in_range = point_voxel_ids(pts, pc_range, grid)
        msk = first_k_in_voxel(lin, msk & in_range, max_points_per_voxel)
    mean = voxel_bin_mean(pts, msk.contiguous(), pc_range, grid)
    return mean[0] if single else mean


def voxelize_mean(points: torch.Tensor, mask: torch.Tensor,
                  pc_range: Sequence[float], grid: Sequence[int],
                  max_points_per_voxel: Optional[int] = None
                  ) -> torch.Tensor:
    """Dense per-voxel feature means [B, Z, Y, X, C] (an [N,C] cloud ->
    [Z, Y, X, C], the JAX package's layout): a view of the z-fold plane."""
    single = points.dim() == 2
    fold = voxelize_bev_zfold(points, mask, pc_range, grid,
                              max_points_per_voxel)
    fold = fold[None] if single else fold
    B, Y, X, _ = fold.shape
    vox = fold.view(B, Y, X, grid[2], points.shape[-1]).permute(0, 3, 1, 2, 4)
    return vox[0] if single else vox


def rasterize_bev_intensity(points: torch.Tensor, mask: torch.Tensor,
                            pc_range: Sequence[float], img: int,
                            intensity_col: int = 3,
                            flip_rows: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Points -> (mean intensity, count) BEV images [B, img, img].

    Row = y bin, col = x bin; with ``flip_rows`` row 0 = y_max (the
    annotation/tile frame of the synthetic labels).  The mean is
    ``sum / max(count, 1)``, taken in the kernel."""
    pts, msk, single = _batched(points, mask)
    mean, cnts = bev_bin_mean(pts.float().contiguous(), msk.contiguous(),
                              pc_range, img, intensity_col, flip_rows)
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
