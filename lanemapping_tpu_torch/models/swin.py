"""Hierarchical shifted-window transformer backbone (Swin), port of
`lanemapping_tpu/models/swin.py` (reference
`backbone/swin_transformer.py:450-633`, registered but never imported
there).

As in the JAX package: window partitioning is reshape/permute, the cyclic
shift is one ``torch.roll`` per shifted block with the -100 mask on pairs
of tokens from different regions, the relative position bias is a table
gather, QK^T and AV accumulate in float32 and the softmax runs in float32
before the probabilities go back to the input dtype.  flax's LayerNorm
(eps 1e-6) and its tanh GELU, flax module names.

Tokens are channels-last inside; the backbone takes an NCHW image and
returns the requested stages NCHW, like the port's other backbones.  In
the JAX package it returns a tuple of stages and so is no Detector1stage
correlator; it exists as a module, and so it does here.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..registry import BACKBONE

LN_EPS = 1e-6  # flax nn.LayerNorm default


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B,H,W,C] -> [B*nW, w*w, C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def window_reverse(x: torch.Tensor, w: int, H: int, W: int) -> torch.Tensor:
    B = x.shape[0] // ((H // w) * (W // w))
    x = x.reshape(B, H // w, W // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def _relative_index(w: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_bias = nn.Parameter(torch.zeros((2 * window - 1) ** 2,
                                                 heads))
        self.proj = nn.Linear(dim, dim)
        # a constant of the module: moves with it, never copied per forward
        self.register_buffer("rel_index", torch.from_numpy(
            _relative_index(window)), persistent=False)

    def forward(self, x, mask=None):
        B_, N, C = x.shape
        hd = self.dim // self.heads
        q, k, v = self.qkv(x).reshape(B_, N, 3, self.heads, hd) \
            .permute(2, 0, 3, 1, 4)
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * hd ** -0.5
        bias = self.rel_bias[self.rel_index].permute(2, 0, 1)
        attn = attn + bias.float()[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(B_ // nw, nw, self.heads, N, N)
                    + mask[None, :, None]).reshape(B_, self.heads, N, N)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn.float(), v.float()).to(x.dtype)
        return self.proj(out.transpose(1, 2).reshape(B_, N, self.dim))


def shift_mask(H: int, W: int, w: int, s: int,
               device=None) -> torch.Tensor:
    """[nW, w*w, w*w]: -100 between tokens of a shifted window that come
    from different regions of the rolled map, else 0 (built on
    ``device``)."""
    img = torch.zeros((1, H, W, 1), device=device)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = window_partition(img, w)[..., 0]
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        """[B,H,W,C] -> [B,H,W,C]."""
        B, H, W, C = x.shape
        w, s = self.window, self.shift
        y = self.norm1(x)
        mask = None
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
            mask = shift_mask(H, W, w, s, device=x.device)
        y = window_reverse(self.attn(window_partition(y, w), mask), w, H, W)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y
        y = F.gelu(self.fc1(self.norm2(x)), approximate="tanh")
        return x + self.fc2(y)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """Multi-stage Swin: [B,C,H,W] image -> the requested stages, NCHW."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 in_channels: int = 3):
        super().__init__()
        p = patch_size
        # flax's default SAME padding is none at kernel = stride
        self.patch_embed = nn.Conv2d(in_channels, embed_dim, p, stride=p)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.depths, self.out_indices = tuple(depths), tuple(out_indices)
        dim = embed_dim
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            for d in range(depth):
                shift = 0 if d % 2 == 0 else window_size // 2
                setattr(self, f"stage{i}_block{d}",
                        SwinBlock(dim, heads, window_size, shift, mlp_ratio))
            if i in self.out_indices:
                setattr(self, f"out_norm{i}", nn.LayerNorm(dim, eps=LN_EPS))
            if i < len(depths) - 1:
                setattr(self, f"merge{i}", PatchMerging(dim))
                dim *= 2

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = self.patch_norm(self.patch_embed(x).permute(0, 2, 3, 1))
        outs = []
        for i, depth in enumerate(self.depths):
            for d in range(depth):
                x = getattr(self, f"stage{i}_block{d}")(x)
            if i in self.out_indices:
                outs.append(getattr(self, f"out_norm{i}")(x)
                            .permute(0, 3, 1, 2))
            if i < len(self.depths) - 1:
                x = getattr(self, f"merge{i}")(x)
        return tuple(outs)


_FIELDS = ("patch_size", "embed_dim", "depths", "num_heads", "window_size",
           "mlp_ratio", "out_indices")


@BACKBONE.register_module(name="SwinTransformer")
def build_swin(cfg=None, **kw):
    return SwinTransformer(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in kw.items() if k in _FIELDS})
