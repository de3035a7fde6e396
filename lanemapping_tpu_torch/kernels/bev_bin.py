"""K1: per-cell (mean, count) BEV binning — the CUDA kernel's wrapper and
its plain PyTorch versions.

The kernel (`csrc/bev_bin.cu`, bucketing in `csrc/bin_bands.cuh`) replaces
the TPU kernel `tests/pallas_reference_bev.py::bev_bin_sums`
(`_bin_kernel`) and its wrapper `rasterize_bev_intensity_pallas` on the
rasterize step of `ops/voxelize.py`.  ``bev_bin_mean`` takes the plain
version only for tensors that lie on the CPU; a CUDA tensor launches the
kernel or raises.  ``bev_bin_sums_ref`` stays as the plain counterpart of
the TPU kernel's per-cell (sum, count).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from .bin_bands import SCRATCH, band_plan
from .build import load_library

_SIGNATURES = {
    "lm_bev_bin_mean": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int] + [ctypes.c_float] * 4 + [ctypes.c_int] * 9
        + [ctypes.c_void_p] * 7,
        ctypes.c_int),
}


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


def bev_bin_mean(points: torch.Tensor, mask: torch.Tensor,
                 pc_range: Sequence[float], img: int,
                 intensity_col: int = 3, flip_rows: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B,N,C] float32 points, [B,N] bool mask -> (mean, cnt) [B,img,img]
    float32 on the points' device.  CUDA tensors run the K1 kernel;
    ``bev_bin_mean.launches`` counts its launches."""
    if points.device.type == "cpu":
        return bev_bin_mean_ref(points, mask, pc_range, img, intensity_col,
                                flip_rows)
    if points.device.type != "cuda":
        raise ValueError(f"bev_bin_mean: unsupported device {points.device}")
    if points.dim() != 3 or points.dtype != torch.float32:
        raise ValueError(f"points must be [B,N,C] float32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    B, N, C = points.shape
    if mask.shape != (B, N) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be [B,N]=[{B},{N}] bool, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if mask.device != points.device:
        raise ValueError("points and mask must be on the same device")
    if not (0 <= intensity_col < C and C >= 2):
        raise ValueError(f"intensity_col {intensity_col} out of range for "
                         f"C={C}")
    if not (points.is_contiguous() and mask.is_contiguous()):
        raise ValueError("points and mask must be contiguous")
    if max(B, N, img) >= 2 ** 31:
        raise ValueError("bev_bin_mean: sizes must fit in int32")
    plan = band_plan(B, N, img, img)
    lo, size = bin_geometry(pc_range, img)
    inv = np.float32(1.0) / size
    mean = torch.empty((B, img, img), dtype=torch.float32,
                       device=points.device)
    cnt = torch.empty_like(mean)
    scratch = plan.scratch(points.device)
    lib = load_library("bev_bin", _SIGNATURES)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        rc = lib.lm_bev_bin_mean(
            points.data_ptr(), mask.data_ptr(), B, N, C,
            float(lo[0]), float(lo[1]), float(inv[0]), float(inv[1]),
            img, intensity_col, int(flip_rows), *plan.kernel_args(),
            *(scratch[k].data_ptr() for k in SCRATCH), mean.data_ptr(),
            cnt.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"bev_bin kernel launch failed: CUDA error {rc}")
    bev_bin_mean.launches += 1
    return mean, cnt


bev_bin_mean.launches = 0

