"""Composition roots Detector1stage and Segmentor (port of
`lanemapping_tpu/models/nets.py`, reference `net/detector1stage.py:10-67`,
`net/segmentor.py:14-51`): pcencoder -> (optional) global correlator ->
lane head, or the encoder alone for segmentation pretraining.  The input is
an image tile, or, for the LiDAR encoder, a raw-point dict
``{"points": [B,N,4], "points_mask": [B,N]}`` (`nets.py:31-34` there).
The KLane heads (RowSharNotReducRef, GridSeg) read the correlator map only
(reference `detector1stage.py:46-47`); the encoder still runs whole, so in
training its semantic pyramids' statistics move as in flax.  The legacy
2-argument Detector is in `models/legacy.py`.

``Detector1stage.forward`` and ``Segmentor.forward`` keep the JAX package's layout at its boundary:
the tile comes in NHWC [B, H, W, 3] and the image-shaped outputs
(``semantic_seg``, ``endp_est``, ``orient``, ``endpoint``) go out NHWC.  A
contiguous NHWC tile is a channels-last NCHW tensor, so the permutes are
free views and the convolutions run channels-last.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
import torch.nn as nn

from ..registry import NET, build_backbone, build_heads, build_pcencoder

_IMAGE_KEYS = ("orient", "endpoint")


class Detector1stage(nn.Module):
    def __init__(self, pcencoder: nn.Module, backbone: Optional[nn.Module],
                 heads: nn.Module, vit_seg: bool = True):
        super().__init__()
        self.pcencoder = pcencoder
        self.backbone = backbone
        self.heads = heads
        self.vit_seg = vit_seg

    def forward(self, proj):
        """[B, H, W, 3] tile, or the raw-point dict of the LiDAR encoder ->
        raw head map dict (NHWC image maps)."""
        if isinstance(proj, dict):
            fea, fea_up, bi_seg, endp_est = self.pcencoder(
                proj["points"], proj.get("points_mask"))
        else:
            fea, fea_up, bi_seg, endp_est = self.pcencoder(
                proj.permute(0, 3, 1, 2))
        if self.vit_seg and self.backbone is not None:
            fea = self.backbone(fea)
        out = self.heads(fea, fea_up, endp_est)
        for k in _IMAGE_KEYS:
            if k in out:
                out[k] = out[k].permute(0, 2, 3, 1)
        out["semantic_seg"] = bi_seg.permute(0, 2, 3, 1)
        out["endp_est"] = endp_est.permute(0, 2, 3, 1)
        return out


class Segmentor(nn.Module):
    def __init__(self, pcencoder: nn.Module):
        super().__init__()
        self.pcencoder = pcencoder

    def forward(self, proj):
        """[B, H, W, 3] tile -> ``semantic_seg`` [B,H,W,3] and ``endp_est``
        [B,H,W,1] logits."""
        _, _, bi_seg, endp_est = self.pcencoder(proj.permute(0, 3, 1, 2))
        return {"semantic_seg": bi_seg.permute(0, 2, 3, 1),
                "endp_est": endp_est.permute(0, 2, 3, 1)}


@NET.register_module(name="Segmentor")
def _build_segmentor(head_type=None, loss_type=None, cfg=None):
    return Segmentor(pcencoder=build_pcencoder(cfg))


@NET.register_module(name="Detector1stage")
def _build_detector1stage(head_type=None, loss_type=None, cfg=None):
    backbone = build_backbone(cfg) if "backbone" in cfg else None
    return Detector1stage(pcencoder=build_pcencoder(cfg), backbone=backbone,
                          heads=build_heads(cfg),
                          vit_seg=cfg.get("vit_seg", True))


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter from ``generator`` (seeded random weights):
    PyTorch's default uniform ranges for convolutions, linears, flax-layout
    ``DenseGeneral`` kernels and the lane-batched linears of
    ``PerLaneConvHead`` (bound 1/sqrt(fan_in)), unit scale and zero shift
    for the norms; the embeddings as the flax initializers draw them: unit
    normal for the position, lane, proposal (``emb_{i}``, ``prop_emb``) and
    query embeddings, N(0, 0.02^2) for the query decoder's ``img_pe`` and
    Swin's relative-position table ``rel_bias``.  The ResnetFPN family's
    transposed convolutions are ``Conv2d``s by their parameters and are
    drawn as such.  BatchNorm running statistics stay at (0, 1)."""
    from .transformer import DenseGeneral
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear,
                                DenseGeneral)):
                bound = (m.fan_in if isinstance(m, DenseGeneral)
                         else m.weight[0].numel()) ** -0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d,
                                nn.GroupNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("pos_embedding", "lane_emb", "query_embed",
                        "prop_emb") or re.fullmatch(r"emb_\d+", leaf):
                p.normal_(generator=generator)
            elif leaf in ("img_pe", "rel_bias"):
                p.normal_(0.0, 0.02, generator=generator)
    return model


def build_model(cfg, seed: Optional[int] = None) -> nn.Module:
    """Build the net from a config (reference `runner.py:76`), in eval mode
    on the CPU.  With ``seed``, the weights are drawn from a
    ``torch.Generator`` seeded with it."""
    from ..registry import build_net
    model = build_net(cfg)
    if seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval()
