"""K2: the training BatchNorm of a bf16 or fp16 activation in one
mixed-precision pass each way — the CUDA kernels' wrappers, their plain
PyTorch versions and the autograd function that joins them.

The kernels (`csrc/batch_norm.cu`) read the activation as [M, C] rows,
channels innermost: a channels-last [N, C, H, W] tensor or an [N, C] one,
C a multiple of 8 (``supported``).  Forward: float32 per-channel sums of
the rows, their float64 total, the mean, the biased variance, invstd and
the running statistics' move, then ``y = (x - mean) * invstd * w + b`` in
the activation's dtype.  Backward: ``sum(dy)``, ``sum(dy * (x - mean))``,
then ``dx``.  Weight, bias and statistics are float32; nothing float32 of
the activation's size is written or saved (the backward pass keeps ``x``
itself).  CUDA tensors launch the kernels or raise; tensors elsewhere
(the CPU, ``meta``) take the plain versions, which compute the same
figures in float64.  ``bn_forward.launches`` and ``bn_backward.launches``
count the launches on the card, and a forward launch counts ``bn_k2``
while a profiler runs (`utils/logger.py::count`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils.logger import count
from .build import load_library

MAX_CTAS = 1024   # rows of the per-CTA partial sums (`csrc/batch_norm.cu`)
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}
_P = ctypes.c_void_p
_SIGNATURES = {
    "lm_bn_forward": (
        [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P, _P,
         ctypes.c_float, ctypes.c_float, _P, _P, _P, ctypes.c_int, _P, _P,
         _P], ctypes.c_int),
    "lm_bn_backward": (
        [_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P, _P, _P,
         ctypes.c_int, _P, _P, _P, _P, _P], ctypes.c_int),
}


def supported(x: torch.Tensor) -> bool:
    """Whether the kernels take ``x``: bf16 or fp16, channels-last [N, C,
    H, W] or contiguous [N, C], C a multiple of 8 and at most 2048, rows
    16-byte aligned."""
    if x.dtype not in _DTYPES or x.numel() == 0 or x.dim() not in (2, 4):
        return False
    c = x.shape[1]
    laid = x.is_contiguous(memory_format=torch.channels_last) \
        if x.dim() == 4 else x.is_contiguous()
    aligned = x.device.type == "meta" or x.data_ptr() % 16 == 0
    return laid and aligned and c % 8 == 0 and c <= 8 * 256


def _rows(t: torch.Tensor) -> torch.Tensor:
    """The [M, C] view of a supported tensor."""
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1]) \
        if t.dim() == 4 else t


def forward_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                running_mean: Optional[torch.Tensor],
                running_var: Optional[torch.Tensor], momentum: float,
                eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``lm_bn_forward``: (y, stats [4, C] float32 =
    mean, invstd, invstd * w, b); moves the running statistics unless
    they are None."""
    r = _rows(x)
    d = r.double()
    var, mean = torch.var_mean(d, dim=0, correction=0)
    invstd = torch.rsqrt(var + eps)
    stats = torch.stack([mean, invstd, invstd * weight.double(),
                         bias.double()]).float()
    y = torch.addcmul(stats[3], r.float() - stats[0], stats[2]).to(x.dtype)
    if running_mean is not None:
        with torch.no_grad():
            running_mean.copy_((1.0 - momentum) * running_mean.double()
                               + momentum * mean)
            running_var.copy_((1.0 - momentum) * running_var.double()
                              + momentum * var)
    return _like(y, x), stats


def backward_ref(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                 stats: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``lm_bn_backward``: (dx, dw, db)."""
    r, g = _rows(x), _rows(dy).double()
    mean, invstd = stats[0], stats[1].double()
    xc = r.double() - mean.double()
    n = r.shape[0]
    s_dy, s_dyx = g.sum(0), (g * xc).sum(0)
    k = weight.double() * invstd
    dx = g * k - xc * (k * invstd * invstd * s_dyx / n) - k * s_dy / n
    return (_like(dx.to(x.dtype), x), (s_dyx * invstd).float(),
            s_dy.float())


def _like(rows: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[M, C] rows back in ``x``'s shape and layout."""
    if x.dim() == 2:
        return rows
    n, c, h, w = x.shape
    return rows.view(n, h, w, c).permute(0, 3, 1, 2)


def _require(x: torch.Tensor, *per_channel: Optional[torch.Tensor]) -> None:
    """Raise unless the kernels take ``x`` and its [C] float32 vectors."""
    if not supported(x):
        raise ValueError(f"batch_norm kernels take bf16/fp16 channels-last "
                         f"[N, C, H, W] or [N, C] with C % 8 == 0, got "
                         f"{tuple(x.shape)} {x.dtype} strides {x.stride()}")
    for t in per_channel:
        if t is not None and (t.dtype != torch.float32 or t.device != x.device
                              or t.shape != (x.shape[1],)
                              or not t.is_contiguous()):
            raise ValueError("batch_norm kernels take contiguous [C] float32 "
                             "per-channel tensors on x's device")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"batch_norm {what} kernel launch failed: CUDA "
                           f"error {rc}")


def bn_forward(x, weight, bias, running_mean, running_var, momentum, eps):
    """(y, stats) of ``forward_ref``: the kernels on a CUDA ``x``."""
    if x.device.type != "cuda":
        return forward_ref(x, weight, bias, running_mean, running_var,
                           momentum, eps)
    _require(x, weight, bias, running_mean, running_var)
    m, c = x.numel() // x.shape[1], x.shape[1]
    y = torch.empty_like(x)
    stats = torch.empty((4, c), dtype=torch.float32, device=x.device)
    part = torch.empty((MAX_CTAS, 2, c), dtype=torch.float32,
                       device=x.device)
    frozen = running_mean is None
    lib = load_library("batch_norm", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.lm_bn_forward(
            x.data_ptr(), m, c, _DTYPES[x.dtype], weight.data_ptr(),
            bias.data_ptr(), eps, momentum,
            None if frozen else running_mean.data_ptr(),
            None if frozen else running_var.data_ptr(), part.data_ptr(),
            MAX_CTAS, stats.data_ptr(), y.data_ptr(), _stream(x))
    _check(rc, "forward")
    bn_forward.launches += 1
    count("bn_k2")
    return y, stats


bn_forward.launches = 0


def bn_backward(dy, x, weight, stats):
    """(dx, dw, db) of ``backward_ref``: the kernels on a CUDA ``x``."""
    if dy.dtype != x.dtype or dy.stride() != x.stride():
        dy = torch.empty_like(x).copy_(dy)
    if x.device.type != "cuda":
        return backward_ref(dy, x, weight, stats)
    _require(x, weight, stats[0], stats[1], stats[2])
    m, c = x.numel() // x.shape[1], x.shape[1]
    dx = torch.empty_like(x)
    dw = torch.empty(c, dtype=torch.float32, device=x.device)
    db = torch.empty_like(dw)
    coef = torch.empty((3, c), dtype=torch.float32, device=x.device)
    part = torch.empty((MAX_CTAS, 2, c), dtype=torch.float32,
                       device=x.device)
    lib = load_library("batch_norm", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.lm_bn_backward(
            dy.data_ptr(), x.data_ptr(), m, c, _DTYPES[x.dtype],
            weight.data_ptr(), stats.data_ptr(), part.data_ptr(), MAX_CTAS,
            coef.data_ptr(), dw.data_ptr(), db.data_ptr(), dx.data_ptr(),
            _stream(x))
    _check(rc, "backward")
    bn_backward.launches += 1
    return dx, dw, db


bn_backward.launches = 0


class MixedBatchNorm(torch.autograd.Function):
    """Training BatchNorm of a supported ``x`` with float32 ``weight`` and
    ``bias``: y in ``x``'s dtype; moves the running statistics toward the
    batch mean and biased variance unless they are None.  Saves ``x``,
    ``weight`` and the [4, C] statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps):
        y, stats = bn_forward(x, weight, bias, running_mean, running_var,
                              momentum, eps)
        ctx.save_for_backward(x, weight, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        dx, dw, db = bn_backward(dy, x, weight, stats)
        return dx, dw, db, None, None, None, None
