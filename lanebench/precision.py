"""How the plain reference computes: at the configuration's own precision
for the comparison, or one step below it for the control.

- ``float32``: float32 weights and activations, TF32 off for matrix
  products and convolutions (the reference the program is held to);
- ``bfloat16``: weights and activations in bf16, the losses in float32
  (the control of a float32 configuration, whose convolutions the program
  runs in PyTorch's default TF32);
- ``float8``: bf16 as above, and every convolution and linear layer takes
  its input and weight rounded to float8 e4m3 with one scale a tensor
  (amax to 448), the gradient passing the rounding unchanged (the control
  of a bf16 configuration).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch
import torch.nn as nn

E4M3_MAX = 448.0


class _E4M3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = x.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
        q = (x.float() / s).to(torch.float8_e4m3fn).float() * s
        return q.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def e4m3(x: torch.Tensor) -> torch.Tensor:
    return _E4M3.apply(x)


def _matmul_modules(model: nn.Module):
    from .plain.models.transformer import DenseGeneral
    return [m for m in model.modules()
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear, DenseGeneral))]


@contextlib.contextmanager
def strict_float32() -> Iterator[None]:
    """TF32 off for matrix products and cuDNN convolutions."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def activation_dtype(level: str) -> torch.dtype:
    return torch.float32 if level == "float32" else torch.bfloat16


def hook_inputs(model: nn.Module, level: str) -> list:
    """Forward pre-hooks that put the activations at ``level``: the LiDAR
    encoder's voxel grid cast to bf16, and under ``float8`` every
    convolution's and linear's input rounded to e4m3.  Returns the
    handles."""
    hs = []
    if level == "float32":
        return hs
    enc = getattr(getattr(model, "pcencoder", None), "zfold_encoder", None)
    if enc is not None:
        hs.append(enc.register_forward_pre_hook(
            lambda m, a: (a[0].to(torch.bfloat16),) + tuple(a[1:])))
    if level == "float8":
        for m in _matmul_modules(model):
            hs.append(m.register_forward_pre_hook(
                lambda m, a: (e4m3(a[0]),) + tuple(a[1:])))
    return hs


def weights_at(model: nn.Module, level: str) -> Dict[str, torch.Tensor]:
    """The parameters as the forward at ``level`` takes them, differentiable
    back to the float32 masters: cast to bf16 below float32, and the
    convolution and linear weights rounded to e4m3 under ``float8``."""
    q = set()
    if level == "float8":
        mm = set(_matmul_modules(model))
        q = {(name + "." if name else "") + "weight"
             for name, m in model.named_modules() if m in mm}
    out = {}
    for n, p in model.named_parameters():
        v = p if level == "float32" else p.to(torch.bfloat16)
        out[n] = e4m3(v) if n in q else v
    return out
