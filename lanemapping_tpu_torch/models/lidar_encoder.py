"""Raw-point BEV encoder (LidarEncoder), port of
`lanemapping_tpu/models/lidar_encoder.py` (reference
`pcencoder/lidarencoder.py:13-129`).

Points [B, N, 4] and their mask go through the z-fold voxelizer
(`ops/voxelize.py::voxelize_bev_zfold`, on the K1z kernel) into a dense
[B, Z*C, Y, X] plane, then a dense 2-D conv stack (``DenseZFoldEncoder``,
the JAX package's stand-in for the reference's spconv SparseEncoder, which
has no dense torch counterpart), a row flip into the annotation frame, a 2x
upsample and the PostProjector2 output contract:

    fea     [B, 64, S, S]      -> global correlator input
    fea_up  [B, 8, 2S, 2S]     -> lane-head fine features
    bi_seg  [B, 3, 8S, 8S]     -> none/solid/dashed logits
    endp    [B, 1, 8S, 8S]     -> endpoint heatmap logits

NCHW; parameter names are the flax module names (``zfold_encoder.stem``,
``s{i}_conv1``, ..., ``fea_aligner``, ``fea_conv``, ``output_layer_*``).
BatchNorm momentum 0.1 is flax's 0.9, eps 1e-5.  Both reference-exact modes
are ported: ``max_points_per_voxel`` (cfg ``ref_exact_voxel_cap``, the
first-K points per voxel) and ``bicubic_upsample``
(cfg ``ref_exact_bicubic_upsample``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.interp import resize_bicubic, resize_bilinear_ac
from ..ops.voxelize import voxelize_bev_zfold
from ..registry import PCENCODER
from .norm import BatchNorm2d

BN_MOMENTUM = 0.1  # flax momentum 0.9
BN_EPS = 1e-5


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


class DenseZFoldEncoder(nn.Module):
    """Dense stand-in for the sparse 3-D encoder: [B, Z*C, Y, X] ->
    [B, 128, Y/4, X/4].  Stage widths (32, 64, 128), the last two with
    stride 2, each a residual pair of 3x3 convs with a 1x1 projection where
    the shape changes."""

    def __init__(self, in_channels: int, output_channels: int = 128,
                 stage_channels: Sequence[int] = (32, 64, 128)):
        super().__init__()
        self.stage_channels = tuple(stage_channels)
        c0 = self.stage_channels[0]
        self.stem = nn.Conv2d(in_channels, c0, 3, padding=1, bias=False)
        self.stem_bn = _bn(c0)
        prev = c0
        for i, ch in enumerate(self.stage_channels):
            stride = 2 if i > 0 else 1
            setattr(self, f"s{i}_conv1", nn.Conv2d(prev, ch, 3, stride=stride,
                                                   padding=1, bias=False))
            setattr(self, f"s{i}_bn1", _bn(ch))
            setattr(self, f"s{i}_conv2", nn.Conv2d(ch, ch, 3, padding=1,
                                                   bias=False))
            setattr(self, f"s{i}_bn2", _bn(ch))
            if stride != 1 or prev != ch:
                setattr(self, f"s{i}_proj", nn.Conv2d(prev, ch, 1,
                                                      stride=stride,
                                                      bias=False))
                setattr(self, f"s{i}_proj_bn", _bn(ch))
            prev = ch
        self.out = nn.Conv2d(prev, output_channels, 1)

    def forward(self, x):
        x = F.relu(self.stem_bn(self.stem(x)))
        for i in range(len(self.stage_channels)):
            y = F.relu(getattr(self, f"s{i}_bn1")(getattr(self,
                                                          f"s{i}_conv1")(x)))
            y = getattr(self, f"s{i}_bn2")(getattr(self, f"s{i}_conv2")(y))
            if hasattr(self, f"s{i}_proj"):
                x = getattr(self, f"s{i}_proj_bn")(
                    getattr(self, f"s{i}_proj")(x))
            x = F.relu(x + y)
        return self.out(x)


class LidarEncoder(nn.Module):
    def __init__(self, Xn: int = 144, Yn: int = 144, out_channels: int = 64,
                 pc_range: Sequence[float] = (-15.0, -25.0, -2.0, 15.0, 25.0,
                                              2.0),
                 grid: Sequence[int] = (576, 576, 10), in_features: int = 4,
                 backbone_channels: int = 128, ds_ratio: int = 8,
                 max_points_per_voxel: Optional[int] = None,
                 bicubic_upsample: bool = False):
        super().__init__()
        self.Xn, self.Yn, self.ds_ratio = Xn, Yn, ds_ratio
        self.pc_range, self.grid = tuple(pc_range), tuple(grid)
        self.max_points_per_voxel = max_points_per_voxel
        self.bicubic_upsample = bicubic_upsample
        self.zfold_encoder = DenseZFoldEncoder(self.grid[2] * in_features,
                                               backbone_channels)
        self.fea_aligner = nn.Conv2d(backbone_channels, out_channels, 3,
                                     padding=1, bias=False)
        self.fea_aligner_bn = _bn(out_channels)
        self.fea_conv = nn.Conv2d(out_channels, out_channels, 5, stride=2,
                                  padding=2)
        self.fea_conv_bn = _bn(out_channels)
        self.output_layer_binary_seg = nn.Conv2d(out_channels, 3, 1)
        self.output_layer_endp = nn.Conv2d(out_channels, 1, 1)
        self.output_layer_fea = nn.Conv2d(out_channels, 8, 1)

    def forward(self, points: torch.Tensor,
                mask: Optional[torch.Tensor] = None):
        """points [B, N, 4] padded (x, y, z, intensity); mask [B, N] marks
        the real points.  Float32 throughout (see
        `models/nets.py::round_weights_as_flax_promotes` for a bf16
        config)."""
        if mask is None:
            mask = torch.ones(points.shape[:2], dtype=torch.bool,
                              device=points.device)
        vox = voxelize_bev_zfold(points, mask, self.pc_range, self.grid,
                                 self.max_points_per_voxel)
        feat = self.zfold_encoder(vox.permute(0, 3, 1, 2))
        # flip rows to match the BEV annotation frame (reference `:70`)
        feat = torch.flip(feat, dims=(2,))
        if self.bicubic_upsample:
            up = resize_bicubic(feat, self.Yn * 2, self.Xn * 2)
        else:
            up = resize_bilinear_ac(feat, self.Yn * 2, self.Xn * 2)
        up = F.relu(self.fea_aligner_bn(self.fea_aligner(up)))
        fea = F.relu(self.fea_conv_bn(self.fea_conv(up)))
        big = self.Yn * self.ds_ratio
        bi_seg = resize_bilinear_ac(
            self.output_layer_binary_seg(F.relu(up)), big, big)
        endp = resize_bilinear_ac(self.output_layer_endp(F.relu(up)), big,
                                  big)
        fea_up = self.output_layer_fea(up)
        return fea, fea_up, bi_seg, endp


@PCENCODER.register_module(name="LidarEncoder")
def build_lidar_encoder(cfg=None, Xn=144, Yn=144, out_channels=64,
                        lidar_encoder=None, **kw):
    """Config-compatible factory (`lidar_encoder.py:132-156` there),
    including the reference key typo ``backnone``."""
    default_range = (-15.0, -25.0, -2.0, 15.0, 25.0, 2.0)
    pc_range = tuple(cfg.get("lidar_point_cloud_range", default_range)) \
        if cfg else default_range
    grid = tuple(cfg.get("grid_size", (576, 576, 10))) if cfg \
        else (576, 576, 10)
    backbone_ch, in_features = 128, 4
    if lidar_encoder and "backnone" in lidar_encoder:  # reference key typo
        backbone_ch = lidar_encoder["backnone"].get("output_channels", 128)
        in_features = lidar_encoder["backnone"].get("in_channels", 4)
    max_ppv = None
    if cfg and cfg.get("ref_exact_voxel_cap", False):
        max_ppv = 10
        if lidar_encoder and "voxelize" in lidar_encoder:
            max_ppv = lidar_encoder["voxelize"].get("max_num_points", 10)
    return LidarEncoder(
        Xn=Xn, Yn=Yn, out_channels=out_channels, pc_range=pc_range,
        grid=grid, in_features=in_features, backbone_channels=backbone_ch,
        ds_ratio=cfg.get("gt_downsample_ratio", 8) if cfg else 8,
        max_points_per_voxel=max_ppv,
        bicubic_upsample=cfg.get("ref_exact_bicubic_upsample", False)
        if cfg else False)
