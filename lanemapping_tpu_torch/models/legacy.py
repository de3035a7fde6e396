"""Legacy KLane components: the plain ResNet projector and the 2-argument
Detector net (port of `lanemapping_tpu/models/legacy.py`; reference
`pcencoder/postprojector.py:30-54,383-415` PostProjector/ResNetWrapper,
`net/detector.py:10-81` Detector), used by
`configs/Proj28_GFC-T3_Seg_82_11_laser.py`.

NCHW inside; ``Detector.forward`` takes the NHWC tile as the other nets
do.  The projector has no torch reference here and takes the flax module
names (``conv1``, ``bn1``, ``layer1``..``layer4``, ``out_conv``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch.nn as nn
import torch.nn.functional as F

from ..registry import NET, PCENCODER, build_backbone, build_heads, \
    build_pcencoder
from .norm import BatchNorm2d
from .resnet_fpn import BN_EPS, BN_MOMENTUM, RESNET_LAYERS, ResStage


class ResNetProjector(nn.Module):
    """ResNet trunk + 1x1 out conv -> one [B, out_channel, S, S] map."""

    def __init__(self, resnet: str = "resnet34",
                 in_channels: Sequence[int] = (64, 128, 256, -1),
                 replace_stride_with_dilation: Sequence[bool] = (False, True,
                                                                  False),
                 out_channel: int = 64):
        super().__init__()
        layers = RESNET_LAYERS[resnet]
        chans = list(in_channels)
        dil = replace_stride_with_dilation
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.layer1 = ResStage(64, chans[0], layers[0])
        self.layer2 = ResStage(chans[0], chans[1], layers[1], 2, dil[0])
        self.layer3 = ResStage(chans[1], chans[2], layers[2], 2, dil[1]) \
            if chans[2] > 0 else None
        self.layer4 = ResStage(chans[2], chans[3], layers[3], 2, dil[2]) \
            if chans[3] > 0 else None
        width = [c for c in chans if c > 0][-1]
        self.out_conv = nn.Conv2d(width, out_channel, 1, bias=False)

    def forward(self, x):
        # max pool pads with -inf, as flax's nn.max_pool
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer2(self.layer1(x))
        for stage in (self.layer3, self.layer4):
            if stage is not None:
                x = stage(x)
        return self.out_conv(x)


@PCENCODER.register_module(name="PostProjector")
def build_postprojector(cfg=None, resnet="resnet34", pretrained=True,
                        replace_stride_with_dilation=(False, True, False),
                        out_conv=True, in_channels=(64, 128, 256, -1), **kw):
    del pretrained, out_conv
    return ResNetProjector(
        resnet=resnet, in_channels=tuple(in_channels),
        replace_stride_with_dilation=tuple(replace_stride_with_dilation),
        out_channel=cfg.featuremap_out_channel if cfg else 64)


class Detector(nn.Module):
    """Legacy 2-argument net: projector -> correlator -> heads(fea)."""

    def __init__(self, pcencoder: nn.Module, backbone: Optional[nn.Module],
                 heads: nn.Module):
        super().__init__()
        self.pcencoder = pcencoder
        self.backbone = backbone
        self.heads = heads

    def forward(self, proj):
        """[B, H, W, 3] tile -> the head's output dict."""
        fea = self.pcencoder(proj.permute(0, 3, 1, 2))
        if self.backbone is not None:
            fea = self.backbone(fea)
        return self.heads(fea)


@NET.register_module(name="Detector")
def _build_detector(head_type=None, loss_type=None, cfg=None):
    backbone = build_backbone(cfg) if "backbone" in cfg else None
    return Detector(pcencoder=build_pcencoder(cfg), backbone=backbone,
                    heads=build_heads(cfg))
