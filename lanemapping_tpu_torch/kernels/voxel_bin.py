"""K1z: per-voxel feature means in the z-fold layout — the CUDA kernel's
wrapper and its plain PyTorch versions.

The kernel (`csrc/voxel_bin.cu`, bucketing in `csrc/bin_bands.cuh`)
replaces the TPU kernel `tests/pallas_reference_bev.py::bev_bin_sums`
(`_bin_kernel`) in its z-fold use (`voxelize_bev_zfold_pallas`) on the
voxelize step of `ops/voxelize.py`.  ``voxel_bin_mean`` takes the plain
version only for tensors that lie on the CPU; a CUDA tensor launches the
kernel or raises.  ``voxel_bin_sums_ref`` stays as the plain counterpart of
the TPU kernel's per-voxel (sums, count).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from .bin_bands import SCRATCH, band_plan
from .build import load_library

_SIGNATURES = {
    "lm_voxel_bin_mean": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int] + [ctypes.c_float] * 6 + [ctypes.c_int] * 9
        + [ctypes.c_void_p] * 6,
        ctypes.c_int),
}


def voxel_geometry(pc_range: Sequence[float], grid: Sequence[int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(lo [3], size [3]) in float32, computed as the JAX package does
    (`ops/voxelize.py:37-39` there: ``size = (hi - lo) / [X, Y, Z]`` in
    f32), so points on a voxel border bin into the same voxel."""
    lo = np.asarray(pc_range[:3], np.float32)
    hi = np.asarray(pc_range[3:6], np.float32)
    return lo, (hi - lo) / np.asarray(grid, np.float32)


def voxel_cells(points: torch.Tensor, pc_range: Sequence[float],
                grid: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B,N,>=3] points -> (ijk [B,N,3] int64 clipped into the grid, valid
    [B,N]): ijk = floor((p - lo) / size), valid where every axis lies in
    [0, dim)."""
    lo, size = voxel_geometry(pc_range, grid)
    q = (points[..., :3] - torch.as_tensor(lo, device=points.device)) \
        / torch.as_tensor(size, device=points.device)
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


def record_floats(n_cols: int) -> int:
    """Floats of K1z's record between its passes: the point itself, padded
    to a power of two."""
    return 1 << (n_cols - 1).bit_length()


def voxel_bin_mean_ref(points: torch.Tensor, mask: torch.Tensor,
                       pc_range: Sequence[float], grid: Sequence[int]
                       ) -> torch.Tensor:
    """Plain version: [B,N,C] points, [B,N] bool mask -> per-voxel means
    [B, Y, X, Z*C] float32, sum / max(count, 1) of ``voxel_bin_sums_ref``;
    empty voxels are 0."""
    sums, cnts = voxel_bin_sums_ref(points, mask, pc_range, grid)
    B, Y, X, Z, C = sums.shape
    return (sums / torch.clamp(cnts, min=1.0)[..., None]).view(B, Y, X, Z * C)


def voxel_bin_mean(points: torch.Tensor, mask: torch.Tensor,
                   pc_range: Sequence[float], grid: Sequence[int]
                   ) -> torch.Tensor:
    """[B,N,C] float32 points, [B,N] bool mask -> per-voxel means
    [B, Y, X, Z*C] float32 on the points' device, for ``grid`` = (X, Y, Z).
    CUDA tensors run the K1z kernel, for 3 <= C <= 8 (``band_plan``);
    ``voxel_bin_mean.launches`` counts its launches."""
    if points.device.type == "cpu":
        return voxel_bin_mean_ref(points, mask, pc_range, grid)
    if points.device.type != "cuda":
        raise ValueError(f"voxel_bin_mean: unsupported device {points.device}")
    if points.dim() != 3 or points.dtype != torch.float32:
        raise ValueError(f"points must be [B,N,C] float32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    B, N, C = points.shape
    if C < 3:
        raise ValueError(f"points need x, y, z columns, got C={C}")
    if mask.shape != (B, N) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be [B,N]=[{B},{N}] bool, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if mask.device != points.device:
        raise ValueError("points and mask must be on the same device")
    if not (points.is_contiguous() and mask.is_contiguous()):
        raise ValueError("points and mask must be contiguous")
    X, Y, Z = (int(g) for g in grid)
    if min(X, Y, Z) < 1 or max(B, N, X, Y, Z) >= 2 ** 31:
        raise ValueError(f"bad grid {tuple(grid)} or sizes beyond int32")
    plan = band_plan(B, N, Y, X, Z, C, record_floats(C))
    lo, size = voxel_geometry(pc_range, (X, Y, Z))
    out = torch.empty((B, Y, X, Z * C), dtype=torch.float32,
                      device=points.device)
    scratch = plan.scratch(points.device)
    lib = load_library("voxel_bin", _SIGNATURES)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        rc = lib.lm_voxel_bin_mean(
            points.data_ptr(), mask.data_ptr(), B, N, C,
            *(float(v) for v in lo), *(float(v) for v in size), X, Y, Z,
            *plan.kernel_args(), *(scratch[k].data_ptr() for k in SCRATCH),
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"voxel_bin kernel launch failed: CUDA error {rc}")
    voxel_bin_mean.launches += 1
    return out


voxel_bin_mean.launches = 0

