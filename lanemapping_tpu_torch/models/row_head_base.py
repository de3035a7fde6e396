"""RowSharNotReducRef_Base, port of `lanemapping_tpu/models/row_head_base.py`
(reference `heads/row_shared_base.py`, registered there but dead): the
intermediate head between RowSharNotReducRef and ColumnProposal2.

Column proposals come from a conv proposal generator and a lane-correlator
transformer over one token per proposal column (objectness straight from
those tokens); ``line_expand`` turns each token back into a column feature,
which joins the encoder's fine map at 2S for the common, upsample,
endpoint and orient convolutions.  Each proposal's windowed row tokens,
weighted by seg attention, then go through a ROW transformer over all B*P
row sequences at once and three Dense-BatchNorm-Dense prediction heads.

The row transformer is the JAX package's deliberate addition (its
`row_head_base.py:16-25,189-200`): the reference's executed forward
comments every row-transformer call out.  The port holds to the JAX
package, not to the reference's executed graph.

Output contract as ColumnProposal2's (``proposal_conf``, ``ext2``,
``cls2``, ``offset2``, ``orient``, ``endpoint``, ``prop_seg_small``), so
``column_proposal_loss`` and the lane decode apply; ``endp_mode="Regr"``
adds ``endp_reg`` [B,4] (sigmoid; init h, w, end h, w over the image
size), whose ``endp_regression_loss`` the Runner does not add, as the JAX
Runner does not.

Layout: inputs NCHW (x [B,C,S,S], x_up [B,C_up,2S,2S]); ``orient`` and
``endpoint`` come out NCHW, the proposal outputs [B, P, ...].  flax module
names throughout (no torch reference is at hand); ``prop_emb`` is flax's
one [P, dim_token] table.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.interp import _upsample_then_pool_np, resize_bilinear_ac
from ..parallel.dist import sum_over_ranks
from ..registry import HEADS
from .norm import BatchNorm1d, BatchNorm2d
from .transformer import LN_EPS, Transformer
from .vit import correlator_out_channels

BN_MOMENTUM = 0.1  # flax momentum 0.9
BN_EPS = 1e-5


def _bn2d(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def _conv(i: int, o: int, k=3, stride: int = 1) -> nn.Conv2d:
    k = (k, k) if isinstance(k, int) else k
    return nn.Conv2d(i, o, k, stride=stride, padding=(k[0] // 2, k[1] // 2))


class RowSharNotReducRefBase(nn.Module):
    def __init__(self, dim_feat: int = 8, row_size: int = 144,
                 dim_shared: int = 512, num_prop: int = 72,
                 prop_width: int = 2, prop_half_buff: int = 4,
                 dim_token: int = 1024, tr_depth: int = 1,
                 tr_heads: int = 16, tr_dim_head: int = 64,
                 tr_mlp_dim: int = 2048, tr_dropout: float = 0.0,
                 row_dim_token: int = 64, row_tr_depth: int = 1,
                 row_tr_heads: int = 10, row_tr_dim_head: int = 12,
                 row_tr_mlp_dim: int = 128, num_orients: int = 11,
                 endp_mode: str = "endpoint", in_channels: int = 8,
                 up_channels: int = 8):
        super().__init__()
        F_, S, P = dim_feat, row_size, num_prop
        self.dim_feat, self.row_size, self.num_prop = F_, S, P
        self.prop_width, self.prop_half_buff = prop_width, prop_half_buff
        self.W = W = prop_width + 2 * prop_half_buff
        self.endp_mode, self.row_dim_token = endp_mode, row_dim_token

        # stage 1: conv proposal generator (reference `:331-336`)
        self.gen_prop_conv1 = _conv(in_channels, 2 * F_, (5, 3))
        self.gen_prop_bn = _bn2d(2 * F_)
        self.gen_prop_conv2 = _conv(2 * F_, 2 * F_, stride=2)
        # stage 2: lane correlator over column tokens (`:243-274,450-460`)
        self.to_token = nn.Linear(2 * F_ * P, dim_token)
        self.prop_emb = nn.Parameter(torch.zeros(P, dim_token))
        self.tr_lane_correlator = Transformer(dim_token, tr_depth, tr_heads,
                                              tr_dim_head, tr_mlp_dim,
                                              tr_dropout)
        self.tr_lane_norm = nn.LayerNorm(dim_token, eps=LN_EPS)
        self.proposal_confidence = nn.Linear(dim_token, 2)
        self.line_expand = nn.Linear(dim_token, 2 * F_ * P)

        con = 2 * F_ + up_channels
        self.common_conv1 = _conv(con, 2 * F_)
        self.common_bn1 = _bn2d(2 * F_)
        self.common_conv2 = _conv(2 * F_, F_, stride=2)
        self.common_bn2 = _bn2d(F_)
        self.upsample_conv1 = _conv(con, 2 * F_, (5, 3))
        self.upsample_bn1 = _bn2d(2 * F_)
        self.upsample_conv2 = _conv(2 * F_, F_)
        self.upsample_bn2 = _bn2d(F_)
        self.endpoint_conv1 = _conv(F_, F_ // 2)
        self.endpoint_bn = _bn2d(F_ // 2)
        self.endpoint_conv2 = _conv(F_ // 2, 1)
        if endp_mode == "Regr":
            self.fc_reg1 = nn.Linear(S * S, S)
            self.fc_reg2 = nn.Linear(S, 4)
        self.orient_conv1 = _conv(F_, F_ // 2)
        self.orient_bn = _bn2d(F_ // 2)
        self.orient_conv2 = _conv(F_ // 2, num_orients)

        # stage 3: all P proposal windows at once (`:494-549`)
        self.bi_seg_proposal = nn.Conv2d(F_, 1, 1)
        self.to_token_row_seg_att = nn.Linear(F_ * W, row_dim_token)
        self.tr_row_correlator = Transformer(row_dim_token, row_tr_depth,
                                             row_tr_heads, row_tr_dim_head,
                                             row_tr_mlp_dim, 0.0)
        self.tr_row_norm = nn.LayerNorm(row_dim_token, eps=LN_EPS)
        # Dense -> BatchNorm -> Dense prediction heads (`:328-347`)
        for name, o in (("ext2", 3), ("cls2", W), ("offset2", W)):
            setattr(self, f"{name}_fc1", nn.Linear(row_dim_token, dim_shared))
            setattr(self, f"{name}_bn", BatchNorm1d(
                dim_shared, eps=BN_EPS, momentum=BN_MOMENTUM))
            setattr(self, f"{name}_fc2", nn.Linear(dim_shared, o))
        # the seg-attention operators (avgpool8 of the 8x upsample of a
        # window, per axis): constants built once, moved with the module,
        # cast on the device, never copied from the host in a forward
        for name, n in (("att_rows", 2 * S), ("att_cols", 2 * W)):
            self.register_buffer(name, torch.from_numpy(
                _upsample_then_pool_np(n, 4 * n, 8)), persistent=False)

    def forward(self, x, x_up, x_endp=None):
        """x [B,C,S,S], x_up [B,C_up,2S,2S] -> raw map dict (``x_endp`` is
        not read, as in the JAX head)."""
        S, P, W = self.row_size, self.num_prop, self.W
        pw, hb = self.prop_width, self.prop_half_buff
        B = x.shape[0]
        out = {}

        fd = self.gen_prop_conv2(self.gen_prop_bn(self.gen_prop_conv1(x)))
        # one token per column, (c h) flatten with h fastest, + embedding
        t = self.to_token(fd.permute(0, 3, 1, 2).reshape(B, P, -1))
        t = t + self.prop_emb.to(t.dtype)[None]
        t = self.tr_lane_norm(self.tr_lane_correlator(t))
        # objectness from the correlator tokens (`:267-270,461`)
        out["proposal_conf"] = self.proposal_confidence(t)
        col = self.line_expand(t).reshape(B, P, -1, P).permute(0, 2, 3, 1)

        # local+global concat at 2S (`:473`), head_common and head_upsample
        con = torch.cat([resize_bilinear_ac(col, 2 * S, 2 * S), x_up], dim=1)
        row_fea = self.common_bn2(self.common_conv2(
            self.common_bn1(self.common_conv1(con))))  # [B,F,S,S]
        prop_fea = self.upsample_bn2(self.upsample_conv2(
            self.upsample_bn1(self.upsample_conv1(con))))  # [B,F,2S,2S]

        e = F.relu(self.endpoint_bn(self.endpoint_conv1(F.relu(row_fea))))
        out["endpoint"] = resize_bilinear_ac(self.endpoint_conv2(e), 8 * S,
                                             8 * S)
        if self.endp_mode == "Regr":
            h = F.relu(self.fc_reg1(row_fea.mean(dim=1).reshape(B, S * S)))
            out["endp_reg"] = torch.sigmoid(self.fc_reg2(h))
        out["orient"] = self.orient_conv2(self.orient_bn(
            self.orient_conv1(row_fea)))

        # every window at once: [B,F,S,P,W] strided views -> [B,P,S,F,W]
        local = F.pad(row_fea, (hb, hb)).unfold(3, W, pw)
        if local.shape[3] < P:
            raise ValueError(f"{P} proposals need a wider map than S={S}")
        local = local[:, :, :, :P].permute(0, 3, 2, 1, 4)
        # the pointwise seg conv once over the padded 2S map, then windowed
        seg_full = self.bi_seg_proposal(F.relu(F.pad(prop_fea,
                                                     (2 * hb, 2 * hb))))[:, 0]
        seg_win = seg_full.unfold(2, 2 * W, 2 * pw)[:, :, :P]
        seg_win = seg_win.permute(0, 2, 1, 3)  # [B,P,2S,2W]
        out["prop_seg_small"] = seg_win
        att = self.att_rows.to(seg_win.dtype) @ seg_win \
            @ self.att_cols.to(seg_win.dtype).T  # [B,P,S,W]
        # (c w) flatten -> row token (`:285-289`)
        tok = (att[:, :, :, None, :] * local).reshape(B, P, S, -1)
        tok = self.to_token_row_seg_att(tok)
        # the row correlator over every (batch, proposal) sequence at once
        rt = self.tr_row_norm(self.tr_row_correlator(
            tok.reshape(B * P, S, self.row_dim_token)))
        tok = rt.reshape(B, P, S, self.row_dim_token)
        for name in ("ext2", "cls2", "offset2"):
            out[name] = self._head(name, tok)
        return out

    def _head(self, name: str, tok: torch.Tensor) -> torch.Tensor:
        """Dense -> BatchNorm -> Dense over [B,P,S,C] tokens; the BatchNorm
        normalises over every leading axis, as flax's does with the channel
        last (BatchNorm1d over a reshape to [N, C], not over a
        transpose)."""
        h = getattr(self, f"{name}_fc1")(tok)
        h = getattr(self, f"{name}_bn")(h.reshape(-1, h.shape[-1]))
        return getattr(self, f"{name}_fc2")(h.reshape(*tok.shape[:-1], -1))


def endp_regression_loss(out, batch, img_size: int) -> torch.Tensor:
    """Weighted L1 on the Regr-mode endpoint FFN (reference
    ``weighted_l1_loss`` `:562-569` and the ``endp_mode=='Regr'`` branch of
    ``loss()``): targets are the first lane's init/end vertices over the
    image size; samples without a lane are masked out.  The count of
    valid samples is the global batch's (summed over the ranks)."""
    pred = out["endp_reg"].float()  # [B,4]
    tgt = torch.cat([batch["initp"][:, 0, :].float(),
                     batch["endp"][:, 0, :].float()], dim=-1) / float(img_size)
    valid = (tgt.abs().sum(dim=-1, keepdim=True) > 0).float()
    l1 = (pred - tgt).abs() * valid
    return l1.sum() / torch.clamp(sum_over_ranks(valid.sum()) * 4.0,
                                  min=1.0)


@HEADS.register_module(name="RowSharNotReducRef_Base")
def build_row_shar_base(cfg=None, dim_feat=8, row_size=144, dim_shared=512,
                        num_prop=72, prop_width=2, prop_half_buff=4,
                        dim_token=1024, tr_depth=1, tr_heads=16,
                        tr_dim_head=64, tr_mlp_dim=2048, row_dim_token=64,
                        row_tr_depth=1, row_tr_heads=10, row_tr_dim_head=12,
                        row_tr_mlp_dim=128, endp_mode="endpoint", **kw):
    return RowSharNotReducRefBase(
        dim_feat=dim_feat, row_size=row_size, dim_shared=dim_shared,
        num_prop=num_prop, prop_width=prop_width,
        prop_half_buff=prop_half_buff, dim_token=dim_token,
        tr_depth=tr_depth, tr_heads=tr_heads, tr_dim_head=tr_dim_head,
        tr_mlp_dim=tr_mlp_dim, row_dim_token=row_dim_token,
        row_tr_depth=row_tr_depth, row_tr_heads=row_tr_heads,
        row_tr_dim_head=row_tr_dim_head, row_tr_mlp_dim=row_tr_mlp_dim,
        num_orients=cfg.number_orients if cfg else 11, endp_mode=endp_mode,
        in_channels=correlator_out_channels(cfg) if cfg is not None
        else dim_feat)
