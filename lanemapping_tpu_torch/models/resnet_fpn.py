"""FPN-on-ResNet BEV feature encoder (PostProjector2), port of
`lanemapping_tpu/models/resnet_fpn.py` (reference
`pcencoder/postprojector.py:56-82,417-655`).

A ResNet-18/34 bottom-up trunk (stage 3 dilated on the flagship, dilation
``[F,T,F]``), an FPN top-down path, and two shared-weight semantic pyramids:

    fea_down  [B, 64, S, S]     (S = img/8)  -> global correlator input
    fea_up    [B, 8, 2S, 2S]                 -> lane-head fine features
    bi_seg    [B, 3, img, img]               -> none/solid/dashed logits
    endp      [B, 1, img, img]               -> endpoint heatmap logits

NCHW; module names are the reference's (``pcencoder.fpn.*``).  BatchNorm
momentum 0.1 is flax's 0.9; GroupNorm eps is torch's 1e-5, as the JAX
package sets it.  The ``s2d_stem``, ``remat`` and ``endp_head_extra`` flags
of the JAX encoder wait for a later slice; a config that sets them is
refused.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from ..ops.interp import resize_bilinear_ac
from ..registry import PCENCODER

BN_MOMENTUM = 0.1  # flax momentum 0.9
BN_EPS = 1e-5

RESNET_LAYERS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
}


class BasicBlock(nn.Module):
    """3x3-3x3 residual block (reference `postprojector.py:299-338`)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False):
        super().__init__()
        d = dilation
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=d,
                               dilation=d, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=d, dilation=d,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.downsample = nn.Sequential(
            nn.Conv2d(in_planes, planes, 1, stride=stride, bias=False),
            nn.BatchNorm2d(planes, eps=BN_EPS, momentum=BN_MOMENTUM)) \
            if has_downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + identity)


def ResStage(in_planes: int, planes: int, num_blocks: int, stride: int = 1,
             dilate: bool = False) -> nn.Sequential:
    """torchvision ``_make_layer``: a dilated stage trades its stride for
    dilation, and its first block keeps the pre-dilation rate 1."""
    dilation = 1
    if dilate:
        dilation, stride = stride, 1
    needs_ds = stride != 1 or in_planes != planes
    blocks = [BasicBlock(in_planes, planes, stride=stride, dilation=1,
                         has_downsample=needs_ds)]
    blocks += [BasicBlock(planes, planes, dilation=dilation)
               for _ in range(1, num_blocks)]
    return nn.Sequential(*blocks)


class FPNEncoder(nn.Module):
    """ResNet trunk + FPN + dual semantic pyramids (the reference's
    ``FPNWrapper``).  ``in_channels``: per-stage widths with -1 marking
    absent trailing stages (shipped configs use [64, 128, 256, -1])."""

    def __init__(self, resnet: str = "resnet34",
                 in_channels: Sequence[int] = (64, 128, 256, -1),
                 replace_stride_with_dilation: Sequence[bool] = (False, True,
                                                                  False),
                 featuremap_out_channel: int = 64, fea_up_channels: int = 8,
                 seg_classes: int = 3):
        super().__init__()
        layers = RESNET_LAYERS[resnet]
        chans = list(in_channels)
        self.has_c4, self.has_c5 = chans[2] > 0, chans[3] > 0
        dil = replace_stride_with_dilation
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.layer1 = ResStage(64, chans[0], layers[0])
        self.layer2 = ResStage(chans[0], chans[1], layers[1], 2, dil[0])
        if self.has_c4:
            self.layer3 = ResStage(chans[1], chans[2], layers[2], 2, dil[1])
        if self.has_c5:
            self.layer4 = ResStage(chans[2], chans[3], layers[3], 2, dil[2])
        width = [c for c in chans if c > 0][-1]
        self.out = nn.Conv2d(width, featuremap_out_channel, 1, bias=False)

        conv1x1 = lambda i, o: nn.Conv2d(i, o, 1)
        conv3x3 = lambda i, o: nn.Conv2d(i, o, 3, padding=1)
        if width != 256:
            # the 256-wide top layer is added to the width-wide laterals
            raise ValueError(f"FPN lateral width must be 256, got {width}")
        self.toplayer = conv1x1(width, 256)
        # laterals, top-down: latlayer1 joins the stage below the top
        lat_in = [c for c in chans if c > 0][:-1][::-1]
        for k, c in enumerate(lat_in, start=1):
            setattr(self, f"latlayer{k}", conv1x1(c, width))
        if self.has_c4:
            self.smooth1 = conv3x3(width, width)
        self.smooth2 = conv3x3(width, width)
        self.smooth3 = conv3x3(width, width)
        half = width // 2
        self.semantic_branch = conv3x3(width, half)
        self.semantic_branch2 = conv3x3(width, half)
        self.conv2 = conv3x3(width, width)
        self.conv3 = conv3x3(width, width)
        self.gn11, self.gn12 = nn.GroupNorm(half, half), nn.GroupNorm(width,
                                                                      width)
        self.gn21, self.gn22 = nn.GroupNorm(half, half), nn.GroupNorm(width,
                                                                      width)
        self.feature_layer = conv1x1(half, fea_up_channels)
        self.output_layer_binary_seg = conv1x1(fea_up_channels, seg_classes)
        self.output_layer_endp = conv1x1(half, 1)

    def forward(self, x):
        img_h, img_w = x.shape[-2:]
        c1 = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        c2 = self.layer1(c1)
        c3 = self.layer2(c2)
        feats = [c2, c3]
        if self.has_c4:
            feats.append(self.layer3(c3))
        if self.has_c5:
            feats.append(self.layer4(feats[-1]))
        fea_down = self.out(feats[-1])

        def up_add(a, b):
            return resize_bilinear_ac(a, *b.shape[-2:]) + b

        # FPN top-down (postprojector.py:584-599)
        p = [self.toplayer(feats[-1])]  # coarsest first
        for k, f in enumerate(feats[-2::-1], start=1):
            p.append(up_add(p[-1], getattr(self, f"latlayer{k}")(f)))
        p = p[::-1]  # p[0] = p2 (finest)
        p2, p3 = p[0], p[1]
        p4 = p[2] if self.has_c4 else None
        p5 = p[3] if self.has_c5 else None
        if self.has_c4:
            p4 = self.smooth1(p4)
        p3 = self.smooth2(p3)
        p2 = self.smooth3(p2)

        # shared-weight semantic pyramids (postprojector.py:604-653)
        h, w = p2.shape[-2:]
        up = lambda a: resize_bilinear_ac(a, h, w)

        def pyramid(conv, sem, gn_wide, gn_half):
            parts = []
            if self.has_c5:
                s5 = up(F.relu(gn_wide(conv(p5))))
                s5 = up(F.relu(gn_wide(conv(s5))))
                parts.append(up(F.relu(gn_half(sem(s5)))))
            if self.has_c4:
                s4 = up(F.relu(gn_wide(conv(p4))))
                parts.append(up(F.relu(gn_half(sem(s4)))))
            parts.append(up(F.relu(gn_half(sem(p3)))))
            parts.append(F.relu(gn_half(sem(p2))))
            return sum(parts)

        fea_up = self.feature_layer(
            pyramid(self.conv2, self.semantic_branch, self.gn12, self.gn11))
        bi_seg = resize_bilinear_ac(
            self.output_layer_binary_seg(F.relu(fea_up)), img_h, img_w)
        endp = resize_bilinear_ac(
            self.output_layer_endp(pyramid(self.conv3, self.semantic_branch2,
                                           self.gn22, self.gn21)),
            img_h, img_w)
        return fea_down, fea_up, bi_seg, endp


class PostProjector2(nn.Module):
    """The reference's wrapper: the encoder lives at ``pcencoder.fpn``."""

    def __init__(self, **kw):
        super().__init__()
        self.fpn = FPNEncoder(**kw)

    def forward(self, x):
        return self.fpn(x)


@PCENCODER.register_module(name="PostProjector2")
def build_postprojector2(resnet="resnet34", pretrained=True,
                         replace_stride_with_dilation=(False, True, False),
                         out_conv=True, in_channels=(64, 128, 256, -1),
                         cfg=None):
    """Config-compatible factory (``pretrained`` is a checkpoint matter)."""
    del pretrained, out_conv
    if cfg is not None:
        for flag in ("s2d_stem", "endp_head_extra"):
            if cfg.get(flag, False):
                raise NotImplementedError(
                    f"cfg.{flag} is not ported to lanemapping_tpu_torch yet")
    return PostProjector2(
        resnet=resnet, in_channels=tuple(in_channels),
        replace_stride_with_dilation=tuple(replace_stride_with_dilation),
        featuremap_out_channel=cfg.featuremap_out_channel if cfg else 64)
