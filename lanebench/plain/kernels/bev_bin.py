"""K1's plain form, frozen: per-cell (mean, count) BEV binning in plain
PyTorch on ``index_put_(accumulate=True)``, on any device."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def bin_geometry(pc_range: Sequence[float], img: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(lo [2], size [2]) in float32, computed as the JAX package does
    (`ops/voxelize.py:128-130` there: ``size = (hi - lo) / img`` in f32).
    The cell of x is floor((x - lo) * (1 / size)) with the reciprocal
    rounded to float32: the JAX package's programs are jitted, and XLA
    turns their division by this constant into that product, so points on
    a cell border bin into the same cell."""
    lo = np.asarray(pc_range[:2], np.float32)
    hi = np.asarray(pc_range[3:5], np.float32)
    return lo, (hi - lo) / np.float32(img)


def bev_bin_sums_ref(points: torch.Tensor, mask: torch.Tensor,
                     pc_range: Sequence[float], img: int,
                     intensity_col: int = 3, flip_rows: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: [B,N,C] points, [B,N] bool mask -> (sums, cnts)
    [B,img,img] float32, built on ``index_put_(accumulate=True)``.

    Cell of a point: col = floor((x - lo_x) * (1 / size_x)) (the
    reciprocal in float32, see ``bin_geometry``), row = the same in y,
    flipped to ``img - 1 - row`` with ``flip_rows``; points outside
    [0, img) on either axis or masked out are dropped."""
    B, N, _ = points.shape
    lo, size = bin_geometry(pc_range, img)
    inv = np.float32(1.0) / size
    q = (points[..., :2] - torch.as_tensor(lo, device=points.device)) \
        * torch.as_tensor(inv, device=points.device)  # [B,N,2]
    valid = mask & ((q >= 0) & (q < img)).all(dim=-1)
    ij = torch.where(valid[..., None], torch.floor(q),
                     torch.zeros((), dtype=q.dtype, device=q.device)).long()
    row = (img - 1) - ij[..., 1] if flip_rows else ij[..., 1]
    tile = torch.arange(B, device=points.device)[:, None]
    lin = (tile * img + row) * img + ij[..., 0]
    vals = torch.where(valid, points[..., intensity_col],
                       torch.zeros((), dtype=points.dtype,
                                   device=points.device))
    sums = torch.zeros(B * img * img, dtype=torch.float32,
                       device=points.device)
    cnts = torch.zeros_like(sums)
    sums.index_put_((lin.reshape(-1),), vals.reshape(-1).float(),
                    accumulate=True)
    cnts.index_put_((lin.reshape(-1),), valid.reshape(-1).float(),
                    accumulate=True)
    return sums.view(B, img, img), cnts.view(B, img, img)


def bev_bin_mean_ref(points: torch.Tensor, mask: torch.Tensor,
                     pc_range: Sequence[float], img: int,
                     intensity_col: int = 3, flip_rows: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: [B,N,C] points, [B,N] bool mask -> (mean, cnt)
    [B,img,img] float32, mean = sum / max(count, 1) of
    ``bev_bin_sums_ref``."""
    sums, cnts = bev_bin_sums_ref(points, mask, pc_range, img,
                                  intensity_col, flip_rows)
    return sums / torch.clamp(cnts, min=1.0), cnts


bev_bin_mean = bev_bin_mean_ref
