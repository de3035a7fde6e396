"""KLane-baseline heads RowSharNotReducRef, GridSeg and PixelSeg, and their
losses (port of `lanemapping_tpu/models/row_head.py`; reference
`heads/row_shared_not_reduc_ref.py`, `heads/grid_seg.py`,
`heads/pixel_seg.py`).

As in the JAX package, the 12 per-lane conv heads are one lane-batched
einsum (``PerLaneConvHead``), every lane's +-2-column window is gathered
unconditionally, the lane correlator runs over all 12 lane tokens, and the
refined windows are written back gated by the existence probability.  The
write-back is 12 out-of-place ``index_put`` calls in lane order: where two
lanes' windows overlap the later lane wins, as in the JAX loop of
``.at[].set``, and only the last writer receives the gradient.  One
``index_put`` over all lanes would hold duplicate indices, whose result is
undefined on CUDA.

Inputs are NCHW correlator maps; the image-shaped outputs (GridSeg's and
PixelSeg's ``cls``) come out NHWC, as the JAX heads return them.  Every
layer takes its input width up front (flax infers it at init).  No torch
reference is at hand for these heads, so the names are the flax module
names; ``PerLaneConvHead`` keeps flax's ``[N, I, O]`` weights.

In a process group of more than one rank each loss is this rank's
contribution to the loss of the global batch (`models/head_losses.py`):
the row count of ``row_shar_loss`` and the element count of each mean are
global, and GridSeg's dice is taken over sums of every rank's rows.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.losses import cross_entropy_with_int_labels
from ..parallel.dist import (get_world_size, global_mean, sum_over_ranks,
                             sum_over_ranks_grad)
from ..registry import HEADS
from .norm import BatchNorm1d
from .resnet_fpn import BN_EPS, BN_MOMENTUM
from .transformer import LN_EPS, Transformer
from .vit import correlator_out_channels


class PerLaneConvHead(nn.Module):
    """12 parallel conv1d(k=1) stacks as lane-batched dense layers."""

    def __init__(self, n_lanes: int, in_dim: int, hidden: int, out_dim: int):
        super().__init__()
        self.w1 = nn.Parameter(torch.empty(n_lanes, in_dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(n_lanes, hidden))
        self.bn = BatchNorm1d(n_lanes * hidden, eps=BN_EPS,
                              momentum=BN_MOMENTUM)
        self.w2 = nn.Parameter(torch.empty(n_lanes, hidden, out_dim))
        self.b2 = nn.Parameter(torch.zeros(n_lanes, out_dim))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        """Uniform weights and biases with bound 1/sqrt(fan_in), as
        torch's default for a linear layer."""
        with torch.no_grad():
            for w, b in ((self.w1, self.b1), (self.w2, self.b2)):
                bound = w.shape[1] ** -0.5
                w.uniform_(-bound, bound, generator=generator)
                b.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        """[B, H, C] shared row tensor -> [B, n_lanes, H, out_dim]."""
        h = torch.einsum("bhc,ncd->bnhd", x, self.w1) + self.b1[None, :,
                                                                 None, :]
        # the JAX head reshapes (not transposes) [B,N,H,D] to [B,H,N*D]:
        # statistics over (B, H) per feature of that reshape
        B, N, H, D = h.shape
        h = self.bn(h.reshape(B * H, N * D)).reshape(B, N, H, D)
        return torch.einsum("bnhd,ndo->bnho", h, self.w2) \
            + self.b2[None, :, None, :]


def write_back(x_pad: torch.Tensor, win: torch.Tensor,
               upd: torch.Tensor) -> torch.Tensor:
    """Write each lane's window ``upd`` [B,N,S,K,F] back into ``x_pad``
    [B,S,W,F] at columns ``win`` [B,N,S,K], lane by lane in order (a later
    lane overwrites an earlier one), out of place."""
    B, N, S = win.shape[:3]
    bidx = torch.arange(B, device=win.device)[:, None, None]
    rows = torch.arange(S, device=win.device)[None, :, None]
    for n in range(N):
        x_pad = x_pad.index_put((bidx, rows, win[:, n]), upd[:, n])
    return x_pad


class RowSharNotReducRef(nn.Module):
    def __init__(self, dim_feat: int = 8, row_size: int = 144,
                 dim_shared: int = 512, n_lanes: int = 12,
                 thr_ext: float = 0.3, off_grid: int = 2,
                 dim_token: int = 1024, tr_depth: int = 1, tr_heads: int = 16,
                 tr_dim_head: int = 64, tr_mlp_dim: int = 2048):
        super().__init__()
        F_, S, N = dim_feat, row_size, n_lanes
        self.dim_feat, self.row_size, self.n_lanes = F_, S, N
        self.thr_ext, self.off_grid = thr_ext, off_grid
        win = F_ * S * (2 * off_grid + 1)
        self.ext1 = PerLaneConvHead(N, F_ * S, dim_shared, 2)
        self.cls1 = PerLaneConvHead(N, F_ * S, dim_shared, S)
        self.to_token = nn.Linear(win, dim_token)
        self.lane_emb = nn.Parameter(torch.randn(N, dim_token))
        self.lane_correlator = Transformer(dim_token, tr_depth, tr_heads,
                                           tr_dim_head, tr_mlp_dim)
        self.corr_norm = nn.LayerNorm(dim_token, eps=LN_EPS)
        self.from_token = nn.Linear(dim_token, win)
        self.ext2 = PerLaneConvHead(N, F_ * S, dim_shared, 2)
        self.cls2 = PerLaneConvHead(N, F_ * S, dim_shared, S)

    def _rows(self, x_nhwc):
        """[B, S, S, F] -> the (c w)-flattened row tensor [B, S, F*S]."""
        B, S = x_nhwc.shape[:2]
        return x_nhwc.permute(0, 1, 3, 2).reshape(B, S, -1)

    def forward(self, x):
        """x [B, F, S, S] correlator map -> stage-1/2 ext and cls probs."""
        F_, S, N = self.dim_feat, self.row_size, self.n_lanes
        og, K = self.off_grid, 2 * self.off_grid + 1
        B = x.shape[0]
        xh = x.permute(0, 2, 3, 1)  # NHWC, as the JAX head indexes it
        row_tensor = self._rows(xh)
        ext1 = torch.softmax(self.ext1(row_tensor), -1)  # [B,N,S,2]
        cls1 = torch.softmax(self.cls1(row_tensor), -1)  # [B,N,S,S]

        # stage 2: lane-token correlation over each lane's column window
        x_pad = F.pad(xh, (0, 0, og, og))  # [B, S, S+2og, F]
        corr = torch.argmax(cls1, dim=-1)  # [B,N,S]
        win = corr[..., None] + torch.arange(K, device=x.device)  # on pad
        bidx = torch.arange(B, device=x.device)
        rows = torch.arange(S, device=x.device)
        window = x_pad[bidx[:, None, None, None], rows[None, None, :, None],
                       win]  # [B,N,S,K,F]
        # token per lane in (c h w) order (reference `:135-137`)
        tok = self.to_token(window.permute(0, 1, 4, 2, 3).reshape(B, N, -1))
        tok = self.lane_correlator(tok + self.lane_emb[None])
        tok = self.from_token(self.corr_norm(tok))
        refined = tok.reshape(B, N, F_, S, K).permute(0, 1, 3, 4, 2)

        gate = ext1[..., 0].mean(-1) > self.thr_ext  # [B,N]
        upd = torch.where(gate[:, :, None, None, None], refined, window)
        row_tensor2 = self._rows(write_back(x_pad, win, upd)[:, :, og:S + og])
        ext2 = torch.softmax(self.ext2(row_tensor2), -1)
        cls2 = torch.softmax(self.cls2(row_tensor2), -1)
        return {"ext": ext1, "cls": cls1, "ext2": ext2, "cls2": cls2}


def row_shar_loss(out: Dict, batch: Dict, n_lanes: int, row_size: int = 144,
                  lambda_cls: float = 1.0) -> Dict:
    """Two-stage CE on softmax probabilities (reference `:395-438`)."""
    EPS = 1e-12
    label = batch["label"][:, :, :row_size].long()  # [B,S,S]
    lane_ids = torch.arange(n_lanes, device=label.device)[None, :, None,
                                                          None]
    onehot_map = label[:, None] == lane_ids  # [B,N,S,S]
    line_ext = onehot_map.sum(-1)  # [B,N,S] lane pixels per row
    ext_oh = torch.stack([line_ext == 1, line_ext == 0], -1).float()
    cls_map = onehot_map.float()
    row_mask = ext_oh[..., 0]  # rows where the lane exists exactly once

    def stage(ext_p, cls_p):
        ext_l = -torch.sum(ext_oh * torch.log(ext_p + EPS)) \
            / (n_lanes * row_size)
        n_rows = torch.clamp(sum_over_ranks(row_mask.sum()), min=1.0)
        cls_l = -torch.sum(cls_map * torch.log(cls_p + EPS)
                           * row_mask[..., None]) * lambda_cls / n_rows
        return ext_l, cls_l

    e1, c1 = stage(out["ext"], out["cls"])
    e2, c2 = stage(out["ext2"], out["cls2"])
    return {"loss": e1 + c1 + e2 + c2,
            "loss_stats": {"ext_loss": e1, "cls_loss": c1,
                           "ext_loss2": e2, "cls_loss2": c2}}


def _conv1(i: int, o: int) -> nn.Conv2d:
    return nn.Conv2d(i, o, 1)


class GridSeg(nn.Module):
    """Grid confidence + class segmentation head (reference
    `grid_seg.py`): two 1x1 convs per branch, no activation between;
    ``num_1`` is unused there too."""

    def __init__(self, num_1: int = 1024, num_2: int = 2048,
                 num_classes: int = 7, in_channels: int = 8):
        super().__init__()
        del num_1
        self.conf_fc1 = _conv1(in_channels, num_2)
        self.conf_fc2 = _conv1(num_2, 1)
        self.cls_fc1 = _conv1(in_channels, num_2)
        self.cls_fc2 = _conv1(num_2, num_classes)

    def forward(self, x):
        conf = torch.sigmoid(self.conf_fc2(self.conf_fc1(x)))
        cls = self.cls_fc2(self.cls_fc1(x))
        return {"conf": conf[:, 0], "cls": cls.permute(0, 2, 3, 1)}


def _format_labels(label: torch.Tensor, num_classes: int, dataset_type: str):
    """The reference's GridSeg label formatting (`grid_seg.py:55-62`):
    both axes flipped (``torch.flip``: torch has no negative strides), the
    background folded into the last class."""
    label = torch.flip(label.long(), dims=(1, 2))
    bg = 0 if dataset_type == "LaserLane" else 255
    shift = 1 if dataset_type == "LaserLane" else 0
    cls_lb = torch.where(label == bg, num_classes - 1, label - shift)
    return label != bg, cls_lb


def grid_seg_loss(out: Dict, batch: Dict, num_classes: int,
                  dataset_type: str = "LaserLane") -> Dict:
    """Dice confidence + CE class loss (reference `grid_seg.py:43-112`)."""
    conf_lb, cls_lb = _format_labels(batch["label"][:, :, :144], num_classes,
                                     dataset_type)
    cls_loss = global_mean(cross_entropy_with_int_labels(out["cls"], cls_lb))
    conf, conf_lb = out["conf"].float(), conf_lb.float()
    # the dice of the global batch, from sums over the ranks; each rank
    # contributes 1/world of it (and, through SumOverRanks, its gradient)
    num = sum_over_ranks_grad(2.0 * torch.sum(conf * conf_lb))
    den = sum_over_ranks_grad(torch.sum(conf ** 2) + torch.sum(
        conf_lb ** 2)) + 1e-6
    conf_loss = (1.0 - num / den) / get_world_size()
    return {"loss": conf_loss + cls_loss,
            "loss_stats": {"conf": conf_loss, "cls": cls_loss}}


@HEADS.register_module(name="RowSharNotReducRef")
def build_row_shar(cfg=None, dim_feat=8, row_size=144, dim_shared=512,
                   lambda_cls=1.0, thr_ext=0.3, off_grid=2, dim_token=1024,
                   tr_depth=1, tr_heads=16, tr_dim_head=64, tr_mlp_dim=2048,
                   **kw):
    del lambda_cls  # a loss weight (`row_shar_loss`)
    return RowSharNotReducRef(
        dim_feat=dim_feat, row_size=row_size, dim_shared=dim_shared,
        n_lanes=cfg.number_lanes if cfg else 12, thr_ext=thr_ext,
        off_grid=off_grid, dim_token=dim_token, tr_depth=tr_depth,
        tr_heads=tr_heads, tr_dim_head=tr_dim_head, tr_mlp_dim=tr_mlp_dim)


@HEADS.register_module(name="GridSeg")
def build_grid_seg(cfg=None, num_1=1024, num_2=2048, num_classes=7, **kw):
    return GridSeg(num_1=num_1, num_2=num_2, num_classes=num_classes,
                   in_channels=correlator_out_channels(cfg) if cfg else 8)


class PixelSeg(nn.Module):
    """Per-pixel class segmentation head: the JAX package's working
    realisation of the reference's broken `heads/pixel_seg.py` stub, a
    3-layer 1x1-conv class predictor over the correlator map."""

    def __init__(self, num_1: int = 64, num_2: int = 128,
                 num_classes: int = 7, in_channels: int = 8):
        super().__init__()
        self.cls_fc0 = _conv1(in_channels, num_1)
        self.cls_fc1 = _conv1(num_1, num_2)
        self.cls_fc2 = _conv1(num_2, num_classes)

    def forward(self, x):
        cls = self.cls_fc2(self.cls_fc1(self.cls_fc0(x)))
        return {"cls": cls.permute(0, 2, 3, 1)}


def pixel_seg_loss(out: Dict, batch: Dict, num_classes: int,
                   dataset_type: str = "LaserLane") -> Dict:
    """CE over per-pixel class labels, formatted as GridSeg's."""
    _, cls_lb = _format_labels(batch["label"][:, :, :out["cls"].shape[2]],
                               num_classes, dataset_type)
    cls_loss = global_mean(cross_entropy_with_int_labels(out["cls"], cls_lb))
    return {"loss": cls_loss, "loss_stats": {"cls": cls_loss}}


# fixed HSV-spread palette for class-map display (`pixel_seg.py:38-41`)
PIXEL_SEG_PALETTE = np.array(
    [[255, 64, 64], [255, 160, 64], [224, 224, 64], [64, 224, 64],
     [64, 192, 224], [96, 64, 255], [224, 64, 224], [0, 0, 0]],
    np.uint8)


def pixel_seg_decode(out: Dict) -> Dict:
    """argmax class map [B,H,W] and its palette RGB render [B,H,W,3]."""
    cls_map = torch.argmax(out["cls"], dim=-1)
    pal = torch.as_tensor(PIXEL_SEG_PALETTE[:out["cls"].shape[-1]],
                          device=cls_map.device)
    rgb = pal[torch.clamp(cls_map, 0, pal.shape[0] - 1)]
    return {"cls_map": cls_map, "rgb": rgb}


@HEADS.register_module(name="PixelSeg")
def build_pixel_seg(cfg=None, num_1=64, num_2=128, num_classes=7, **kw):
    return PixelSeg(num_1=num_1, num_2=num_2, num_classes=num_classes,
                    in_channels=correlator_out_channels(cfg) if cfg else 8)
