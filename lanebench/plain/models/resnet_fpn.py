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
package sets it.  The JAX encoder's three flags, which the reference does
not have, keep their flax names:

- ``s2d_stem``: the 7x7/s2 stem as a 4x4/s1 convolution ``conv1_s2d`` on
  the 2x2 space-to-depth input, channels ordered ``bh*2C + bw*C + c`` as
  the JAX reshape orders them; a 7x7 kernel maps onto it exactly
  (``s2d_stem_kernel``, ``load_s2d_stem``);
- ``endp_head_extra``: a 3x3 conv ``endp_extra`` + GroupNorm
  ``gn_endp_extra`` + ReLU on the endpoint pyramid sum;
- ``remat`` / ``remat_policy``: the trunk stages ``layer1..layer4`` under
  ``torch.utils.checkpoint`` (``RematStage``).
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.interp import resize_bilinear_ac
from ..registry import PCENCODER
from .norm import BatchNorm2d, GroupNorm, frozen_batch_stats

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
        self.bn1 = BatchNorm2d(planes, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=d, dilation=d,
                               bias=False)
        self.bn2 = BatchNorm2d(planes, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.downsample = nn.Sequential(
            nn.Conv2d(in_planes, planes, 1, stride=stride, bias=False),
            BatchNorm2d(planes, eps=BN_EPS, momentum=BN_MOMENTUM)) \
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


def _save_convolutions(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the convolution outputs, recompute the
    rest (JAX's ``dots_with_no_batch_dims_saveable``)."""
    if op == torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class RematStage(nn.Sequential):
    """A trunk stage under ``torch.utils.checkpoint`` (``use_reentrant=
    False``): its activations are recomputed in the backward pass, all of
    them (``"full"``) or all but the convolution outputs (``"dots"``).  The
    blocks keep the names of the stage without remat (``layer1.0....``).

    Two things differ from a plain ``checkpoint(stage, x)``:

    - the recompute runs the blocks on the parameter tensors of the forward
      (handed to ``checkpoint`` as inputs), not on the module's own: under
      the train step's ``functional_call`` those are the bf16 casts, which
      are gone from the module by the time the backward pass runs;
    - BatchNorm's running statistics move in the forward only, as under
      flax's ``nn.remat``; the recompute normalises with the same batch
      statistics and leaves the buffers alone.
    """

    def __init__(self, stage: nn.Sequential, policy: str = "full"):
        super().__init__(*stage)
        if policy not in ("full", "dots"):
            raise KeyError(f"unknown remat_policy {policy!r}")
        self.policy = policy

    def forward(self, x):
        if not (self.training and torch.is_grad_enabled()):
            return super().forward(x)
        names = [[n for n, _ in block.named_parameters()] for block in self]
        # getattr, not get_parameter: under functional_call the attributes
        # hold the swapped-in tensors, which are no Parameters
        tensors = [functools.reduce(getattr, n.split("."), block)
                   for block, ns in zip(self, names) for n in ns]
        calls = []

        def run(inp, *ts):
            # the first call is the forward, any later one a recompute
            with frozen_batch_stats(self, bool(calls)):
                calls.append(None)
                it = iter(ts)
                for block, ns in zip(self, names):
                    inp = torch.func.functional_call(
                        block, {n: next(it) for n in ns}, (inp,))
                return inp

        kw = {}
        if self.policy == "dots":
            kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
                _save_convolutions)
        return checkpoint(run, x, *tensors, use_reentrant=False, **kw)


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B,C,H,W] -> [B,4C,H/2,W/2], channel ``bh*2C + bw*C + c`` as the JAX
    encoder's NHWC reshape orders it (``F.pixel_unshuffle`` would order
    them ``c*4 + bh*2 + bw``)."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // 2, 2, W // 2, 2)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(B, 4 * C, H // 2, W // 2)


def s2d_stem_kernel(w7: np.ndarray) -> np.ndarray:
    """Exact kernel transform for the space-to-depth stem (a copy of the
    JAX package's): [7,7,C,F] stride-2 kernel (flax HWIO) -> [4,4,4C,F]
    stride-1 kernel on the 2x2 space-to-depth input.  The 7x7 kernel is
    zero-padded to 8x8 with the zero row/col FIRST (so output position m
    reads input rows 2m-4..2m+3, matching the (2,1) conv padding), then
    each 2x2 phase folds into the channel slot the forward's reshape
    produces (bh*2C + bw*C + c)."""
    w7 = np.asarray(w7)
    K, _, C, F_ = w7.shape
    assert K == 7, w7.shape
    w8 = np.zeros((8, 8, C, F_), w7.dtype)
    w8[1:, 1:] = w7
    # [8,8,C,F] -> [4,bh,4,bw,C,F] -> [4,4,bh,bw,C,F] -> [4,4,4C,F]
    w = w8.reshape(4, 2, 4, 2, C, F_).transpose(0, 2, 1, 3, 4, 5)
    return np.ascontiguousarray(w.reshape(4, 4, 4 * C, F_))


def s2d_stem_weight(w7: torch.Tensor) -> torch.Tensor:
    """``s2d_stem_kernel`` on a torch OIHW [F,C,7,7] kernel -> [F,4C,4,4]."""
    w = s2d_stem_kernel(w7.detach().float().cpu().numpy()
                        .transpose(2, 3, 1, 0))
    return torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).to(w7.dtype)


def load_s2d_stem(sd: Dict[str, torch.Tensor],
                  own: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A state dict for a model whose keys are ``own``: where the model has
    an s2d stem ``<p>.conv1_s2d.weight`` and ``sd`` holds a 7x7 stem
    ``<p>.conv1.weight`` instead (a reference ``.pth``, a model trained
    without the flag), the 7x7 kernel goes in through ``s2d_stem_weight``
    (JAX `port_torch_ckpt.py:236-242`).  A trained s2d kernel is no 7x7
    kernel, so the other direction does not exist."""
    out = dict(sd)
    for k, v in sd.items():
        if not k.endswith("conv1.weight") or v.dim() != 4 \
                or v.shape[-1] != 7:
            continue
        s2d = k[:-len("conv1.weight")] + "conv1_s2d.weight"
        if s2d in own and s2d not in sd and k not in own:
            out[s2d] = s2d_stem_weight(v)
            del out[k]
    return out


class FPNEncoder(nn.Module):
    """ResNet trunk + FPN + dual semantic pyramids (the reference's
    ``FPNWrapper``).  ``in_channels``: per-stage widths with -1 marking
    absent trailing stages (shipped configs use [64, 128, 256, -1])."""

    def __init__(self, resnet: str = "resnet34",
                 in_channels: Sequence[int] = (64, 128, 256, -1),
                 replace_stride_with_dilation: Sequence[bool] = (False, True,
                                                                  False),
                 featuremap_out_channel: int = 64, fea_up_channels: int = 8,
                 seg_classes: int = 3, remat: bool = False,
                 remat_policy: str = "full", endp_head_extra: bool = False,
                 s2d_stem: bool = False):
        super().__init__()
        layers = RESNET_LAYERS[resnet]
        chans = list(in_channels)
        self.has_c4, self.has_c5 = chans[2] > 0, chans[3] > 0
        dil = replace_stride_with_dilation
        self.s2d_stem = s2d_stem
        if s2d_stem:
            # padded (2,1) by hand: the zero-padded 8x8 kernel covers input
            # rows 2m-4..2m+3, i.e. s2d rows m-2..m+1
            self.conv1_s2d = nn.Conv2d(12, 64, 4, bias=False)
        else:
            self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=BN_EPS, momentum=BN_MOMENTUM)
        stage = (lambda m: RematStage(m, remat_policy)) if remat \
            else (lambda m: m)
        self.layer1 = stage(ResStage(64, chans[0], layers[0]))
        self.layer2 = stage(ResStage(chans[0], chans[1], layers[1], 2,
                                     dil[0]))
        if self.has_c4:
            self.layer3 = stage(ResStage(chans[1], chans[2], layers[2], 2,
                                         dil[1]))
        if self.has_c5:
            self.layer4 = stage(ResStage(chans[2], chans[3], layers[3], 2,
                                         dil[2]))
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
        self.gn11, self.gn12 = GroupNorm(half, half), GroupNorm(width, width)
        self.gn21, self.gn22 = GroupNorm(half, half), GroupNorm(width, width)
        self.feature_layer = conv1x1(half, fea_up_channels)
        self.output_layer_binary_seg = conv1x1(fea_up_channels, seg_classes)
        self.endp_head_extra = endp_head_extra
        if endp_head_extra:
            self.endp_extra = conv3x3(half, half)
            self.gn_endp_extra = GroupNorm(half, half)
        self.output_layer_endp = conv1x1(half, 1)

    def forward(self, x):
        img_h, img_w = x.shape[-2:]
        if self.s2d_stem:
            c1 = self.conv1_s2d(F.pad(_space_to_depth(x), (2, 1, 2, 1)))
        else:
            c1 = self.conv1(x)
        c1 = F.max_pool2d(F.relu(self.bn1(c1)), 3, 2, 1)
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
        e_sum = pyramid(self.conv3, self.semantic_branch2, self.gn22,
                        self.gn21)
        if self.endp_head_extra:
            e_sum = F.relu(self.gn_endp_extra(self.endp_extra(e_sum)))
        endp = resize_bilinear_ac(self.output_layer_endp(e_sum), img_h, img_w)
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
    flag = cfg.get if cfg is not None else (lambda k, d: d)
    return PostProjector2(
        resnet=resnet, in_channels=tuple(in_channels),
        replace_stride_with_dilation=tuple(replace_stride_with_dilation),
        featuremap_out_channel=cfg.featuremap_out_channel if cfg else 64,
        remat=flag("remat", False), remat_policy=flag("remat_policy", "full"),
        endp_head_extra=flag("endp_head_extra", False),
        s2d_stem=flag("s2d_stem", False))
