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
reference checkpoint loads with ``load_state_dict``.

Two optional branches replace the correlator map before the local+global
concat, as the JAX head's (`column_head.py:120-123,215-305` there):

- ``column_att`` (reference `:132-188,317-346`): a Conv_Pool_2d stack
  downsamples the map to one column per proposal, each column becomes a
  token with its own position embedding (the reference's ``emb_{i}``, one
  parameter per proposal), the lane-correlator transformer and LayerNorm
  run over the P tokens, and ``line_expand`` turns each token back into a
  column feature.  Reference names throughout.
- ``column_transformer_decoder``: the JAX package's working stand-in for a
  reference branch that raises ``AttributeError`` (it calls modules its
  ``__init__`` never defines): P learned queries cross-attend over 8x8
  patch embeddings of the map.  flax names throughout.

Training (``self.training``) follows the JAX head's ``train=True``: the
endpoint branch, which only ``endp_mode='endpoint'`` reads, still runs on
a [B, C+1, 1, 1] zero input so that its BatchNorm statistics move as flax
moves them, and without ``fused_seg_focal`` the per-proposal
full-resolution seg logits ``prop_bi_seg`` [B,P,8S,8W] are built for the
unfused loss.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.interp import (_interp_matrix_np, _upsample_then_pool_np,
                          resize_bilinear_ac)
from ..registry import HEADS
from .norm import BatchNorm1d, BatchNorm2d, Dropout
from .transformer import (LN_EPS, CrossAttention, FeedForward, Transformer)
from .vit import correlator_out_channels, patchify

BN_MOMENTUM = 0.1  # flax momentum 0.9
BN_EPS = 1e-5


def _bn2d(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def _conv3(i: int, o: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(i, o, 3, stride=stride, padding=1)


def _operator(m, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(m, dtype=like.dtype, device=like.device)


class ConvPoolStack(nn.Module):
    """Reference ``Conv_Pool_2d`` (`polyline_fpn_vit_vertex_2.py:48-61`):
    ``layers.0`` a (5,3) convolution, then one [ReLU, BatchNorm, stride-2
    convolution] stage ``layers.{i}`` per width."""

    def __init__(self, input_dim: int, hidden_dims, output_dim: int):
        super().__init__()
        chans = [input_dim] + list(hidden_dims) + [output_dim]
        layers = [nn.Conv2d(input_dim, input_dim, (5, 3), padding=(2, 1))]
        for i, o in zip(chans[:-1], chans[1:]):
            layers.append(nn.Sequential(nn.ReLU(), _bn2d(i),
                                        _conv3(i, o, stride=2)))
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


def column_pool_stages(row_size: int, num_prop: int) -> int:
    """The stride-2 stages that take S rows to one column per proposal;
    ``ValueError`` unless S = P * 2^k (JAX `column_head.py:233-238`)."""
    k = max(1, int(math.log2(max(1, row_size // num_prop))))
    if num_prop << k != row_size:
        raise ValueError(
            f"column_att needs row_size to be num_prop * 2^k (reference "
            f"supports num_prop in {{72,36,18}} at S=144); got S={row_size}, "
            f"P={num_prop}")
    return k


class ColumnProposalHead(nn.Module):
    def __init__(self, dim_feat: int = 8, row_size: int = 144,
                 dim_shared: int = 100, num_prop: int = 72,
                 prop_width: int = 2, prop_half_buff: int = 4,
                 num_orients: int = 11, spatial_att: bool = True,
                 endp_mode: str = "endp_est", in_channels: int = 8,
                 up_channels: int = 8, fused_seg_focal: bool = True,
                 column_att: bool = False,
                 column_transformer_decoder: bool = False,
                 dim_token: int = 1024, tr_depth: int = 1, tr_heads: int = 16,
                 tr_dim_head: int = 64, tr_mlp_dim: int = 2048,
                 tr_dropout: float = 0.0, tr_emb_dropout: float = 0.0):
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

        self.column_att = column_att
        self.column_transformer_decoder = column_transformer_decoder
        # both branches map the correlator map [B,C,S,S] to [B,C,S,P]
        C = in_channels
        if column_att:
            k = column_pool_stages(row_size, num_prop)
            self.generate_line_proposal = nn.Sequential(ConvPoolStack(
                C, [C * 2 ** i for i in range(1, k)], C * 2 ** k))
            self.to_token = nn.Sequential(
                nn.Identity(), nn.Linear(C * 2 ** k * num_prop, dim_token))
            for i in range(num_prop):
                setattr(self, f"emb_{i}", nn.Parameter(torch.zeros(dim_token)))
            self.emb_dropout = Dropout(tr_emb_dropout)
            self.tr_lane_correlator = nn.Sequential(
                Transformer(dim_token, tr_depth, tr_heads, tr_dim_head,
                            tr_mlp_dim, tr_dropout),
                nn.LayerNorm(dim_token, eps=LN_EPS))
            self.line_expand = nn.Sequential(
                nn.Linear(dim_token, C * row_size))
        elif column_transformer_decoder:
            n = row_size // 8  # 8x8 patches
            self.to_patch_embedding = nn.Linear(64 * C, dim_token)
            self.img_pe = nn.Parameter(torch.zeros(n * n, dim_token))
            self.kv_norm = nn.LayerNorm(dim_token, eps=LN_EPS)
            self.query_embed = nn.Parameter(torch.zeros(num_prop, dim_token))
            self.tr_depth = tr_depth
            for d in range(tr_depth):
                setattr(self, f"dec{d}_norm1",
                        nn.LayerNorm(dim_token, eps=LN_EPS))
                setattr(self, f"dec{d}_xattn", CrossAttention(
                    dim_token, tr_heads, tr_dim_head, dim_token))
                setattr(self, f"dec{d}_norm2",
                        nn.LayerNorm(dim_token, eps=LN_EPS))
                setattr(self, f"dec{d}_mlp",
                        FeedForward(dim_token, tr_mlp_dim, tr_dropout))
            self.dec_out_norm = nn.LayerNorm(dim_token, eps=LN_EPS)
            self.reverse_query_embedding = nn.Linear(dim_token, C * row_size)

    def _column_attention(self, x: torch.Tensor) -> torch.Tensor:
        """[B,C,S,S] -> [B,C,S,P]: one token per proposal column, tokens
        built at once where the reference loops over batch and proposals."""
        B, C, S, _ = x.shape
        P = self.num_prop
        fd = self.generate_line_proposal(x)  # [B,C',P,P]
        # one token per column; (c h) flatten order, h fastest (`:159-162`)
        t = self.to_token[1](fd.permute(0, 3, 1, 2).reshape(B, P, -1))
        emb = torch.stack([getattr(self, f"emb_{i}") for i in range(P)])
        t = self.emb_dropout(t + emb.to(t.dtype))
        t = self.tr_lane_correlator(t)
        col = self.line_expand[0](t)  # [B,P,C*S], (c h) per token
        return col.reshape(B, P, C, S).permute(0, 2, 3, 1)

    def _column_query_decoder(self, x: torch.Tensor) -> torch.Tensor:
        """[B,C,S,S] -> [B,C,S,P]: P learned lane queries cross-attend over
        8x8 patch embeddings (+ learned position embeddings) of the map in
        pre-norm blocks, then expand to per-proposal column features as
        ``line_expand`` does."""
        B, C, S, _ = x.shape
        P = self.num_prop
        kv = self.to_patch_embedding(patchify(x, 8))  # (p1 p2 c) patches
        kv = self.kv_norm(kv + self.img_pe.to(kv.dtype))
        q = self.query_embed.to(kv.dtype).expand(B, -1, -1)
        for d in range(self.tr_depth):
            qn = getattr(self, f"dec{d}_norm1")(q)
            q = q + getattr(self, f"dec{d}_xattn")(qn, kv)
            qn = getattr(self, f"dec{d}_norm2")(q)
            q = q + getattr(self, f"dec{d}_mlp")(qn)
        col = self.reverse_query_embedding(self.dec_out_norm(q))
        return col.reshape(B, P, C, S).permute(0, 2, 3, 1)

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

        if self.column_att:
            x = self._column_attention(x)  # [B,C,S,P]
        elif self.column_transformer_decoder:
            x = self._column_query_decoder(x)  # [B,C,S,P]

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
    in_ch = correlator_out_channels(cfg) if cfg is not None else 8
    return ColumnProposalHead(
        dim_feat=dim_feat, row_size=row_size, dim_shared=dim_shared,
        num_prop=num_prop, prop_width=prop_width,
        prop_half_buff=prop_half_buff,
        num_orients=cfg.number_orients if cfg else 11,
        spatial_att=cfg.get("spatial_att", True) if cfg else True,
        endp_mode=kw.get("endp_mode", "endp_est"), in_channels=in_ch,
        fused_seg_focal=cfg.get("fused_seg_focal", True) if cfg else True,
        column_att=cfg.get("column_att", False) if cfg else False,
        column_transformer_decoder=cfg.get(
            "column_transformer_decoder", False) if cfg else False,
        dim_token=kw.get("dim_token", 1024), tr_depth=kw.get("tr_depth", 1),
        tr_heads=kw.get("tr_heads", 16),
        tr_dim_head=kw.get("tr_dim_head", 64),
        tr_mlp_dim=kw.get("tr_mlp_dim", 2048),
        tr_dropout=kw.get("tr_dropout", 0.0),
        tr_emb_dropout=kw.get("tr_emb_dropout", 0.0))
