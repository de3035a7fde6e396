"""K1z's plain form, frozen: per-voxel feature means in the z-fold layout
in plain PyTorch on ``index_put_(accumulate=True)``, on any device."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def voxel_geometry(pc_range: Sequence[float], grid: Sequence[int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(lo [3], size [3]) in float32, computed as the JAX package does
    (`ops/voxelize.py:37-39` there: ``size = (hi - lo) / [X, Y, Z]`` in
    f32).  The voxel of p is floor((p - lo) * (1 / size)) with the
    reciprocal rounded to float32: the JAX package's programs are jitted,
    and XLA turns their division by this constant into that product, so
    points on a voxel border bin into the same voxel."""
    lo = np.asarray(pc_range[:3], np.float32)
    hi = np.asarray(pc_range[3:6], np.float32)
    return lo, (hi - lo) / np.asarray(grid, np.float32)


def voxel_cells(points: torch.Tensor, pc_range: Sequence[float],
                grid: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B,N,>=3] points -> (ijk [B,N,3] int64 clipped into the grid, valid
    [B,N]): ijk = floor((p - lo) * (1 / size)) (``voxel_geometry``), valid
    where every axis lies in [0, dim)."""
    lo, size = voxel_geometry(pc_range, grid)
    q = (points[..., :3] - torch.as_tensor(lo, device=points.device)) \
        * torch.as_tensor(np.float32(1.0) / size, device=points.device)
    dims = torch.as_tensor(np.asarray(grid, np.float32), device=points.device)
    valid = ((q >= 0) & (q < dims)).all(dim=-1)
    hi = torch.as_tensor(np.asarray(grid) - 1, device=points.device)
    ijk = torch.minimum(torch.floor(q).long().clamp(min=0), hi)
    return ijk, valid


def voxel_bin_sums_ref(points: torch.Tensor, mask: torch.Tensor,
                       pc_range: Sequence[float], grid: Sequence[int]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: [B,N,C] points, [B,N] bool mask -> (sums
    [B,Y,X,Z,C], cnts [B,Y,X,Z]) float32, built on
    ``index_put_(accumulate=True)``.  Points outside the grid on any axis
    or masked out are dropped."""
    B, N, C = points.shape
    X, Y, Z = grid
    ijk, valid = voxel_cells(points, pc_range, grid)
    valid = valid & mask
    tile = torch.arange(B, device=points.device)[:, None]
    lin = ((tile * Y + ijk[..., 1]) * X + ijk[..., 0]) * Z + ijk[..., 2]
    lin = torch.where(valid, lin, torch.zeros_like(lin)).reshape(-1)
    feats = torch.where(valid[..., None], points.float(),
                        torch.zeros((), device=points.device))
    sums = torch.zeros((B * Y * X * Z, C), dtype=torch.float32,
                       device=points.device)
    cnts = torch.zeros(B * Y * X * Z, dtype=torch.float32,
                       device=points.device)
    sums.index_put_((lin,), feats.reshape(-1, C), accumulate=True)
    cnts.index_put_((lin,), valid.reshape(-1).float(), accumulate=True)
    return sums.view(B, Y, X, Z, C), cnts.view(B, Y, X, Z)


def voxel_bin_mean(points: torch.Tensor, mask: torch.Tensor,
                   pc_range: Sequence[float], grid: Sequence[int]
                   ) -> torch.Tensor:
    """Per-voxel means [B, Y, X, Z*C] float32, sum / max(count, 1);
    empty voxels are 0."""
    sums, cnts = voxel_bin_sums_ref(points, mask, pc_range, grid)
    B, Y, X, Z, C = sums.shape
    return (sums / torch.clamp(cnts, min=1.0)[..., None]).view(B, Y, X, Z * C)
