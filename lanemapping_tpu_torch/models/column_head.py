"""Column-proposal lane decoder head (ColumnProposal2), port of the live
path of `lanemapping_tpu/models/column_head.py` (reference
`heads/polyline_fpn_vit_vertex_2.py:65-600`).

All P proposals are handled at once, as in the JAX package: the proposal
windows are strided views (``unfold``) of the zero-padded feature maps, the
spatial attention is the fused upsample-then-avgpool operator pair applied
to the windowed proposal-seg logits, and the four small heads run as single
matmuls over [B, P, S, C] tokens.

Geometry (flagship config): row_size S=144, num_prop P=72, prop_width=2,
prop_half_buff=4, so each proposal sees a W = 2+2*4 = 10 column window at
stride 2 on the zero-padded [S, S+8] map.

Layout: inputs NCHW (x [B,F,S,S], x_up [B,F,2S,2S], x_endp [B,1,8S,8S]);
``orient`` and ``endpoint`` come out NCHW, the proposal outputs as
[B, P, ...] like the JAX package.  Module names are the reference's, so a
reference checkpoint loads with ``load_state_dict``.  The ``column_att`` and
``column_transformer_decoder`` branches wait for a later slice.

Training (``self.training``) follows the JAX head's ``train=True``: the
endpoint branch, which only ``endp_mode='endpoint'`` reads, still runs on
a [B, C+1, 1, 1] zero input so that its BatchNorm statistics move as flax
moves them, and without ``fused_seg_focal`` the per-proposal
full-resolution seg logits ``prop_bi_seg`` [B,P,8S,8W] are built for the
unfused loss.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.interp import (_interp_matrix_np, _upsample_then_pool_np,
                          resize_bilinear_ac)
from ..registry import HEADS
from .norm import BatchNorm1d, BatchNorm2d
from .vit import correlator_out_channels

BN_MOMENTUM = 0.1  # flax momentum 0.9
BN_EPS = 1e-5


def _bn2d(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def _conv3(i: int, o: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(i, o, 3, stride=stride, padding=1)


def _operator(m, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(m, dtype=like.dtype, device=like.device)


class ColumnProposalHead(nn.Module):
    def __init__(self, dim_feat: int = 8, row_size: int = 144,
                 dim_shared: int = 100, num_prop: int = 72,
                 prop_width: int = 2, prop_half_buff: int = 4,
                 num_orients: int = 11, spatial_att: bool = True,
                 endp_mode: str = "endp_est", in_channels: int = 8,
                 up_channels: int = 8, fused_seg_focal: bool = True):
        super().__init__()
        F_ = dim_feat
        self.dim_feat, self.row_size, self.num_prop = F_, row_size, num_prop
        self.prop_width, self.prop_half_buff = prop_width, prop_half_buff
        self.W = prop_width + 2 * prop_half_buff
        self.spatial_att, self.endp_mode = spatial_att, endp_mode
        self.fused_seg_focal = fused_seg_focal
        # local+global concat: correlator map + the encoder's fea_up
        col_ch = in_channels + up_channels
        # endpoint branch (reference `:371-373`): parameters always exist so
        # checkpoints port either way; it only runs for endp_mode='endpoint'
        self.endpoint = nn.Sequential(
            _conv3(col_ch + 1, F_ // 2), nn.ReLU(), _bn2d(F_ // 2),
            _conv3(F_ // 2, 1))
        self.head_common_layers = nn.Sequential(
            _conv3(col_ch, 2 * F_), _bn2d(2 * F_),
            _conv3(2 * F_, 2 * F_, stride=2), _bn2d(2 * F_))
        self.orient = nn.Sequential(
            _conv3(2 * F_, F_), _bn2d(F_), _conv3(F_, num_orients))
        self.bi_seg_proposal = nn.Conv2d(col_ch, 1, 1)
        tok_ch = 2 * F_ * self.W
        self.proposal_confidence = nn.Sequential(
            nn.Identity(), nn.Linear(tok_ch * row_size, 2))

        def head1d(out_ch):
            return nn.Sequential(
                nn.Conv1d(tok_ch, dim_shared, 1),
                BatchNorm1d(dim_shared, eps=BN_EPS, momentum=BN_MOMENTUM),
                nn.Conv1d(dim_shared, out_ch, 1))

        self.ext2 = head1d(3)
        self.cls2 = head1d(self.W)
        self.offset2 = head1d(self.W)

    @staticmethod
    def _conv1d_head(seq: nn.Sequential, tok: torch.Tensor) -> torch.Tensor:
        """The reference's Conv1d(k=1)-BN-Conv1d over tokens, as two linears
        on [..., C] with the BatchNorm over the flattened token axis (the
        same statistics as BatchNorm1d over (B*P, C, S))."""
        h = F.linear(tok, seq[0].weight[:, :, 0], seq[0].bias)
        h = seq[1](h.reshape(-1, h.shape[-1])).reshape(h.shape)
        return F.linear(h, seq[2].weight[:, :, 0], seq[2].bias)

    def forward(self, x, x_up, x_endp):
        """-> raw map dict."""
        S, P, W = self.row_size, self.num_prop, self.W
        pw, hb = self.prop_width, self.prop_half_buff
        B = x.shape[0]
        need_prop_seg = self.training and not self.fused_seg_focal
        out = {}

        col_fea_up = torch.cat([resize_bilinear_ac(x, 2 * S, 2 * S), x_up],
                               dim=1)  # [B,2F,2S,2S]
        if self.endp_mode == "endpoint":
            e_in = torch.cat([resize_bilinear_ac(col_fea_up, 8 * S, 8 * S),
                              x_endp], dim=1)
            out["endpoint"] = self.endpoint(F.relu(e_in))
        elif self.training:
            # flax's head runs the branch on zeros (`column_head.py:135-143`
            # there): no output, but its BatchNorm statistics move
            self.endpoint(x.new_zeros((B, col_fea_up.shape[1] + 1, 1, 1)))

        row_fea = self.head_common_layers(col_fea_up)  # [B,2F,S,S]
        out["orient"] = self.orient(row_fea)  # [B,O,S,S]

        # all P proposal windows at once: [B,2F,S,n_win,W] strided views
        row_pad = F.pad(row_fea, (hb, hb))
        local = row_pad.unfold(3, W, pw)
        if local.shape[3] < P:
            raise ValueError(f"{P} proposals need a wider map than S={S}")
        local = local[:, :, :, :P].permute(0, 3, 2, 1, 4)  # [B,P,S,2F,W]

        if self.spatial_att or need_prop_seg:
            # pointwise seg conv once over the padded map (== per window,
            # reference `:400`), then window the 1-channel map
            col_pad = F.pad(col_fea_up, (2 * hb, 2 * hb))
            seg_full = self.bi_seg_proposal(F.relu(col_pad))[:, 0]
            seg_win = seg_full.unfold(2, 2 * W, 2 * pw)[:, :, :P]
            seg_win = seg_win.permute(0, 2, 1, 3)  # [B,P,2S,2W]
            out["prop_seg_small"] = seg_win
        if need_prop_seg:
            # align-corners upsample (2S,2W) -> (8S,8W) as two operators
            uh = _operator(_interp_matrix_np(2 * S, 8 * S), seg_win)
            uw = _operator(_interp_matrix_np(2 * W, 8 * W), seg_win)
            out["prop_bi_seg"] = uh @ seg_win @ uw.T
        if self.spatial_att:
            # attention = avgpool8(upsample(seg logits)); the reference
            # multiplies the *raw* logits into the features (`:400-402`)
            ch = _operator(_upsample_then_pool_np(2 * S, 8 * S, 8), seg_win)
            cw = _operator(_upsample_then_pool_np(2 * W, 8 * W, 8), seg_win)
            att = ch @ seg_win @ cw.T  # [B,P,S,W]
            tokens = att[:, :, :, None, :] * local
        else:
            tokens = local

        # (c w) channel order matches the reference token flattening
        tok = tokens.reshape(B, P, S, -1)  # [B,P,S,2F*W]
        # proposal objectness: flatten (c w h) with h fastest (`:200-204`)
        flat = tok.transpose(2, 3).reshape(B, P, -1)
        out["proposal_conf"] = self.proposal_confidence[1](flat)
        out["ext2"] = self._conv1d_head(self.ext2, tok)
        out["cls2"] = self._conv1d_head(self.cls2, tok)
        out["offset2"] = self._conv1d_head(self.offset2, tok)
        return out


@HEADS.register_module(name="ColumnProposal2")
def build_column_proposal2(cfg=None, dim_feat=8, row_size=144, dim_shared=100,
                           num_prop=72, prop_width=2, prop_half_buff=4, **kw):
    if cfg is not None:
        for flag in ("column_att", "column_transformer_decoder"):
            if cfg.get(flag, False):
                raise NotImplementedError(
                    f"cfg.{flag} is not ported to lanemapping_tpu_torch yet")
    in_ch = correlator_out_channels(cfg) if cfg is not None else 8
    return ColumnProposalHead(
        dim_feat=dim_feat, row_size=row_size, dim_shared=dim_shared,
        num_prop=num_prop, prop_width=prop_width,
        prop_half_buff=prop_half_buff,
        num_orients=cfg.number_orients if cfg else 11,
        spatial_att=cfg.get("spatial_att", True) if cfg else True,
        endp_mode=kw.get("endp_mode", "endp_est"), in_channels=in_ch,
        fused_seg_focal=cfg.get("fused_seg_focal", True) if cfg else True)
