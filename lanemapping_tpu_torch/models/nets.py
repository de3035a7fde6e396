"""Composition root Detector1stage (port of `lanemapping_tpu/models/nets.py`,
reference `net/detector1stage.py:10-67`): pcencoder -> (optional) global
correlator -> lane head.  Image input only; the LiDAR encoder and the
Segmentor wait for later slices.

``Detector1stage.forward`` keeps the JAX package's layout at its boundary:
the tile comes in NHWC [B, H, W, 3] and the image-shaped outputs
(``semantic_seg``, ``endp_est``, ``orient``, ``endpoint``) go out NHWC.  A
contiguous NHWC tile is a channels-last NCHW tensor, so the permutes are
free views and the convolutions run channels-last.
"""

from __future__ import annotations

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

    def forward(self, proj: torch.Tensor):
        """[B, H, W, 3] tile -> raw head map dict (NHWC image maps)."""
        x = proj.permute(0, 3, 1, 2)
        fea, fea_up, bi_seg, endp_est = self.pcencoder(x)
        if self.vit_seg and self.backbone is not None:
            fea = self.backbone(fea)
        out = self.heads(fea, fea_up, endp_est)
        for k in _IMAGE_KEYS:
            if k in out:
                out[k] = out[k].permute(0, 2, 3, 1)
        out["semantic_seg"] = bi_seg.permute(0, 2, 3, 1)
        out["endp_est"] = endp_est.permute(0, 2, 3, 1)
        return out


@NET.register_module(name="Detector1stage")
def _build_detector1stage(head_type=None, loss_type=None, cfg=None):
    backbone = build_backbone(cfg) if "backbone" in cfg else None
    return Detector1stage(pcencoder=build_pcencoder(cfg), backbone=backbone,
                          heads=build_heads(cfg),
                          vit_seg=cfg.get("vit_seg", True))


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter from ``generator`` (seeded random weights):
    PyTorch's default uniform ranges for convolutions and linears (bound
    1/sqrt(fan_in)), unit scale and zero shift for the norms, unit normal
    for embeddings.  BatchNorm running statistics stay at (0, 1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                bound = m.weight[0].numel() ** -0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d,
                                nn.GroupNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for name, p in model.named_parameters():
            if name.endswith("pos_embedding"):
                p.normal_(generator=generator)
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
