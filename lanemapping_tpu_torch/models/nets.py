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
from ..utils.logger import trace_span
from .row_head import GridSeg, PerLaneConvHead, RowSharNotReducRef

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
        raw head map dict (NHWC image maps).  Outside training the call is
        the span ``serve.forward`` (the training step has its own)."""
        if self.training:
            return self._forward(proj)
        with trace_span("serve.forward"):
            return self._forward(proj)

    def _forward(self, proj):
        if isinstance(proj, dict):
            fea, fea_up, bi_seg, endp_est = self.pcencoder(
                proj["points"], proj.get("points_mask"))
        else:
            fea, fea_up, bi_seg, endp_est = self.pcencoder(
                proj.permute(0, 3, 1, 2))
        if self.vit_seg and self.backbone is not None:
            fea = self.backbone(fea)
        if isinstance(self.heads, (RowSharNotReducRef, GridSeg)):
            out = self.heads(fea)
        else:
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
            if isinstance(m, PerLaneConvHead):
                m.reset_parameters(generator)
            elif isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear,
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


def round_weights_as_flax_promotes(model: nn.Module) -> nn.Module:
    """What the JAX streaming script computes when it casts a bf16 config's
    weights to bf16 and feeds the net float32 input (the LiDAR path,
    `tools/stream_map.py:96-100,131-133` there): flax promotes every layer
    to float32, so the weights are bf16-rounded and the compute is float32,
    except BatchNorm's inference multiplier, which flax takes from the bf16
    running variance: ``rsqrt(var + eps)`` rounds to bf16 (XLA on the CPU
    then multiplies it by the scale in float32).

    In place on ``model`` (float32): every floating parameter and buffer is
    rounded to bf16, and each BatchNorm's multiplier is taken as above and
    stored in its weight, with running variance 1.
    """
    bf16 = torch.bfloat16
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if t.is_floating_point():
                t.copy_(t.to(bf16))
        for m in model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm) \
                    and m.running_var is not None:
                # each bf16 op rounds a float32 result, as XLA computes it
                eps = torch.tensor(m.eps, dtype=bf16).float()
                var = (m.running_var.float() + eps).to(bf16).float()
                inv = (1.0 / torch.sqrt(var)).to(bf16).float()
                # the layer divides by sqrt(1 + eps): carry that factor
                m.weight.mul_(inv * (1.0 + m.eps) ** 0.5)
                m.running_var.fill_(1.0)
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
