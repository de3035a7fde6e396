"""Bilinear resize with ``align_corners=True`` semantics, and bicubic.

Port of `lanemapping_tpu/ops/interp.py`.  The JAX package wrote the resize
as two dense 1-D operator matmuls because gathers map poorly onto the TPU
(`interp.py:1-12, :148-159` there); on the GPU the natural form is
``F.interpolate(..., mode="bilinear", align_corners=True)``, which is also
what the reference uses.  The small NumPy operators stay: the column head
applies the fused upsample-then-avgpool operator to its narrow proposal
windows, where a [S, 2S] x [2S, 2W] product is the cheapest form.
``resize_bicubic`` (the LiDAR encoder's ``ref_exact_bicubic_upsample``)
applies the JAX package's bicubic operators, copied, so both packages
compute the same taps and border clamps.

Layout: torch NCHW (``...CHW``), where the JAX package used NHWC.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _interp_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] align-corners linear interpolation operator."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    if n_in == 1:
        return np.ones((n_out, 1), dtype=np.float32)
    if n_out == 1:
        m = np.zeros((1, n_in), dtype=np.float32)
        m[0, 0] = 1.0
        return m
    scale = (n_in - 1) / (n_out - 1)
    coords = np.arange(n_out, dtype=np.float64) * scale
    lo = np.floor(coords).astype(np.int64)
    lo = np.clip(lo, 0, n_in - 2)
    frac = coords - lo
    m = np.zeros((n_out, n_in), dtype=np.float32)
    m[np.arange(n_out), lo] = (1.0 - frac).astype(np.float32)
    m[np.arange(n_out), lo + 1] = frac.astype(np.float32)
    return m


@functools.lru_cache(maxsize=None)
def _cubic_interp_matrix_np(n_in: int, n_out: int,
                            align_corners: bool = False,
                            a: float = -0.75) -> np.ndarray:
    """[n_out, n_in] bicubic (Keys, a=-0.75) interpolation operator matching
    ``F.interpolate(mode='bicubic')`` semantics (reference
    `pcencoder/lidarencoder.py:72`).  Border taps clamp (replicate), like
    PyTorch."""
    if n_in == 1:
        return np.ones((n_out, 1), dtype=np.float32)
    if align_corners:
        src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / max(n_out - 1,
                                                                    1)
    else:
        src = (np.arange(n_out, dtype=np.float64) + 0.5) * n_in / n_out - 0.5

    def kernel(t):
        t = np.abs(t)
        return np.where(t <= 1.0, (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1,
                        np.where(t < 2.0,
                                 a * t ** 3 - 5 * a * t ** 2 + 8 * a * t
                                 - 4 * a, 0.0))

    lo = np.floor(src).astype(np.int64)
    m = np.zeros((n_out, n_in), dtype=np.float64)
    rows = np.arange(n_out)
    for tap in (-1, 0, 1, 2):
        idx = lo + tap
        np.add.at(m, (rows, np.clip(idx, 0, n_in - 1)), kernel(src - idx))
    return m.astype(np.float32)


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int,
                   align_corners: bool = False) -> torch.Tensor:
    """Bicubic resize of ``...HW`` tensors as two operator products."""
    h, w = x.shape[-2], x.shape[-1]
    mh = torch.as_tensor(_cubic_interp_matrix_np(h, out_h, align_corners),
                         dtype=x.dtype, device=x.device)
    mw = torch.as_tensor(_cubic_interp_matrix_np(w, out_w, align_corners),
                         dtype=x.dtype, device=x.device)
    return mh @ x @ mw.T


@functools.lru_cache(maxsize=None)
def _pool_matrix_np(n_in: int, k: int) -> np.ndarray:
    """[n_in//k, n_in] average-pooling operator (stride == kernel == k)."""
    n_out = n_in // k
    m = np.zeros((n_out, n_in), dtype=np.float32)
    for i in range(n_out):
        m[i, i * k:(i + 1) * k] = 1.0 / k
    return m


@functools.lru_cache(maxsize=None)
def _upsample_then_pool_np(n_in: int, n_up: int, k: int) -> np.ndarray:
    """Composite operator: align-corners upsample to n_up, then avg-pool by k.

    Fuses the reference's ``avg_pool2d(upsample(x))`` pattern
    (`heads/polyline_fpn_vit_vertex_2.py:295-296,400-402`) into one
    [n_up//k, n_in] matrix so the full-resolution intermediate never exists.
    """
    return _pool_matrix_np(n_up, k) @ _interp_matrix_np(n_in, n_up)


# PyTorch's channels-last bilinear kernels on a card, forward and backward,
# refuse an input or output of INT_MAX (2^31 - 1) elements or more; the JAX
# package's operator products have no such limit.  A resize that would
# reach it runs over slices of the batch, each below it.
RESIZE_MAX_ELEMENTS = 2 ** 31 - 1


def resize_bilinear_ac(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Align-corners bilinear resize of NCHW tensors.

    A same-size resize is the identity (the operator is ``eye``), so it
    returns ``x`` itself.  The degenerate sizes agree with the operator form
    of `_interp_matrix_np`: ``n_in == 1`` replicates, ``n_out == 1`` takes
    the first pixel (PyTorch's align-corners scale is 0 for a 1-pixel
    output).

    Where the input or the output reaches ``RESIZE_MAX_ELEMENTS``, the
    resize runs over batch slices below it; every sample is computed as in
    one call.  Under autograd the slices are concatenated (the gradient
    reaches each slice's backward, itself below the limit); without it each
    slice is written into one preallocated output, which spares the
    concatenation's copy of the whole output (serving the flagship at 128
    to 219 tiles on an H100 80GB HBM3 at 700 W runs 1.7-2.4% faster so).
    """
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    n, c = x.shape[:2]
    per_sample = c * max(x.shape[-2] * x.shape[-1], out_h * out_w)
    rows = max(1, (RESIZE_MAX_ELEMENTS - 1) // max(per_sample, 1))
    if n <= rows:
        return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                             align_corners=True)
    if x.requires_grad and torch.is_grad_enabled():
        return torch.cat([F.interpolate(s, size=(out_h, out_w),
                                        mode="bilinear", align_corners=True)
                          for s in x.split(rows)])
    fmt = torch.channels_last \
        if x.is_contiguous(memory_format=torch.channels_last) \
        else torch.contiguous_format
    out = torch.empty((n, c, out_h, out_w), dtype=x.dtype, device=x.device,
                      memory_format=fmt)
    for i in range(0, n, rows):
        torch.ops.aten.upsample_bilinear2d.out(
            x[i:i + rows], [out_h, out_w], True, None, None,
            out=out[i:i + rows])
    return out


def upsample_then_avgpool(x: torch.Tensor, up_h: int, up_w: int,
                          k: int) -> torch.Tensor:
    """avg_pool_k(resize_ac(x, up_h, up_w)) on ``...HW`` tensors without the
    full-resolution intermediate: two small operator products."""
    h, w = x.shape[-2], x.shape[-1]
    mh = torch.as_tensor(_upsample_then_pool_np(h, up_h, k), dtype=x.dtype,
                         device=x.device)
    mw = torch.as_tensor(_upsample_then_pool_np(w, up_w, k), dtype=x.dtype,
                         device=x.device)
    return mh @ x @ mw.T
