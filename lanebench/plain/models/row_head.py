"""The KLane row-wise head RowSharNotReducRef, its write-back and its loss
``row_shar_loss`` (a frozen copy of the program's
`models/row_head.py`; reference `heads/row_shared_not_reduc_ref.py`,
`models/row_head.py:94-150` of WHU-USI3DV/LaneMapping), and the KLane net
that feeds it: the whole encoder runs (in training its semantic
pyramids' statistics move), and the correlator map alone goes to the
head (reference `detector1stage.py:46-47`).

The 12 per-lane conv1d(k=1) heads are one lane-batched product with
``[N, I, O]`` weights, as in the program; each lane's +-2-column window
is gathered, the lane correlator runs over all 12 lane tokens, and the
refined windows are written back lane by lane (the later lane wins where
two overlap) where the lane's stage-1 existence passes ``thr_ext``.

One addition to the published head: ``forward`` takes a ``route``, the
discrete decisions of another run (each lane-row's window start
``[B, N, S]`` and each lane's gate ``[B, N]``), and follows it in place
of its own; a route of fewer tiles than the batch covers the first ones.
Everything else it computes itself.  With no route it is the published
head.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.dist import sum_over_ranks
from .norm import BatchNorm1d
from .resnet_fpn import BN_EPS, BN_MOMENTUM
from .transformer import LN_EPS, Transformer

Route = Tuple[torch.Tensor, torch.Tensor]  # (window starts, gates)


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

    def forward(self, x):
        """[B, H, C] shared row tensor -> [B, n_lanes, H, out_dim]."""
        h = torch.einsum("bhc,ncd->bnhd", x, self.w1) + self.b1[None, :,
                                                                 None, :]
        # statistics over (B, H) per feature of the [B, H, N*D] reshape
        B, N, H, D = h.shape
        h = self.bn(h.reshape(B * H, N * D)).reshape(B, N, H, D)
        return torch.einsum("bnhd,ndo->bnho", h, self.w2) \
            + self.b2[None, :, None, :]


def write_back(x_pad: torch.Tensor, win: torch.Tensor,
               upd: torch.Tensor) -> torch.Tensor:
    """Each lane's window ``upd`` [B,N,S,K,F] written into ``x_pad``
    [B,S,W,F] at columns ``win`` [B,N,S,K], lane by lane in order, out of
    place."""
    B, N, S = win.shape[:3]
    bidx = torch.arange(B, device=win.device)[:, None, None]
    rows = torch.arange(S, device=win.device)[None, :, None]
    for n in range(N):
        x_pad = x_pad.index_put((bidx, rows, win[:, n]), upd[:, n])
    return x_pad


def _pinned(own: torch.Tensor, given: Optional[torch.Tensor]
            ) -> torch.Tensor:
    """``given`` over the first tiles of ``own``, ``own`` beyond them."""
    if given is None:
        return own
    given = given.to(own.device, own.dtype)
    return torch.cat([given, own[given.shape[0]:]]) \
        if given.shape[0] < own.shape[0] else given


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

    @staticmethod
    def _rows(x_nhwc):
        """[B, S, S, F] -> the (c w)-flattened row tensor [B, S, F*S]."""
        B, S = x_nhwc.shape[:2]
        return x_nhwc.permute(0, 1, 3, 2).reshape(B, S, -1)

    def forward(self, x, route: Optional[Route] = None):
        """x [B, F, S, S] correlator map -> stage-1/2 ext and cls
        probabilities, and ``route``, the decisions taken."""
        F_, S, N = self.dim_feat, self.row_size, self.n_lanes
        og, K = self.off_grid, 2 * self.off_grid + 1
        B = x.shape[0]
        xh = x.permute(0, 2, 3, 1)
        row_tensor = self._rows(xh)
        ext1 = torch.softmax(self.ext1(row_tensor), -1)  # [B,N,S,2]
        cls1 = torch.softmax(self.cls1(row_tensor), -1)  # [B,N,S,S]

        x_pad = F.pad(xh, (0, 0, og, og))  # [B, S, S+2og, F]
        with torch.no_grad():
            corr = torch.argmax(cls1, dim=-1)  # [B,N,S]
            gate = ext1[..., 0].mean(-1) > self.thr_ext  # [B,N]
        if route is not None:
            corr, gate = _pinned(corr, route[0]), _pinned(gate, route[1])
        win = corr[..., None] + torch.arange(K, device=x.device)
        bidx = torch.arange(B, device=x.device)
        rows = torch.arange(S, device=x.device)
        window = x_pad[bidx[:, None, None, None], rows[None, None, :, None],
                       win]  # [B,N,S,K,F]
        tok = self.to_token(window.permute(0, 1, 4, 2, 3).reshape(B, N, -1))
        tok = self.lane_correlator(tok + self.lane_emb[None])
        tok = self.from_token(self.corr_norm(tok))
        refined = tok.reshape(B, N, F_, S, K).permute(0, 1, 3, 4, 2)

        upd = torch.where(gate[:, :, None, None, None], refined, window)
        row_tensor2 = self._rows(write_back(x_pad, win, upd)[:, :, og:S + og])
        ext2 = torch.softmax(self.ext2(row_tensor2), -1)
        cls2 = torch.softmax(self.cls2(row_tensor2), -1)
        return {"ext": ext1, "cls": cls1, "ext2": ext2, "cls2": cls2,
                "route": (corr, gate)}


def row_shar_loss(out: Dict, batch: Dict, n_lanes: int, row_size: int = 144,
                  lambda_cls: float = 1.0) -> Dict:
    """Two-stage cross-entropy on the softmax probabilities (reference
    `:395-438`): per lane and row, existence (the lane's pixels in the row
    exactly one, or none) over all rows, and the column over the rows where
    the lane has exactly one pixel."""
    EPS = 1e-12
    label = batch["label"][:, :, :row_size].long()  # [B,S,S]
    lane_ids = torch.arange(n_lanes, device=label.device)[None, :, None,
                                                          None]
    onehot_map = label[:, None] == lane_ids  # [B,N,S,S]
    line_ext = onehot_map.sum(-1)  # [B,N,S] lane pixels per row
    ext_oh = torch.stack([line_ext == 1, line_ext == 0], -1).float()
    cls_map = onehot_map.float()
    row_mask = ext_oh[..., 0]

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


class KLaneNet(nn.Module):
    """Encoder -> correlator -> RowSharNotReducRef on the correlator map
    (the program's ``Detector1stage`` with a KLane head); NHWC tile in,
    the head's outputs and the encoder's ``semantic_seg`` and
    ``endp_est`` (NHWC) out."""

    def __init__(self, pcencoder: nn.Module, backbone: Optional[nn.Module],
                 heads: RowSharNotReducRef, vit_seg: bool = True):
        super().__init__()
        self.pcencoder = pcencoder
        self.backbone = backbone
        self.heads = heads
        self.vit_seg = vit_seg

    def forward(self, proj, route: Optional[Route] = None):
        fea, _, bi_seg, endp_est = self.pcencoder(proj.permute(0, 3, 1, 2))
        if self.vit_seg and self.backbone is not None:
            fea = self.backbone(fea)
        out = self.heads(fea, route)
        out["semantic_seg"] = bi_seg.permute(0, 2, 3, 1)
        out["endp_est"] = endp_est.permute(0, 2, 3, 1)
        return out


def build_klane(cfg: Dict) -> KLaneNet:
    """The KLane net of a resolved configuration (float32, eval mode, on
    the current default device); the weights are drawn by
    `lanebench/rows.py`."""
    from .. import ConfigDict
    from ..registry import build_backbone, build_pcencoder
    from . import resnet_fpn, vit  # noqa: F401  (their registrations)

    c = ConfigDict(cfg)
    h = c.heads
    head = RowSharNotReducRef(
        dim_feat=h.dim_feat, row_size=h.row_size, dim_shared=h.dim_shared,
        n_lanes=c.number_lanes, thr_ext=h.thr_ext, off_grid=h.off_grid,
        dim_token=h.dim_token, tr_depth=h.tr_depth, tr_heads=h.tr_heads,
        tr_dim_head=h.tr_dim_head, tr_mlp_dim=h.tr_mlp_dim)
    backbone = build_backbone(c) if "backbone" in c else None
    return KLaneNet(build_pcencoder(c), backbone, head,
                    c.get("vit_seg", True)).eval()
