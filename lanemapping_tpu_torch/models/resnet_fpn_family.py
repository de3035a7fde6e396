"""KLane conv-FPN backbone family (ResnetFPN .. ResnetFPN4_Dilated, CBAM),
port of `lanemapping_tpu/models/resnet_fpn_family.py` (reference
`backbone/resnet_fpn.py:13-568`).

Nine registered variants of one architecture, parameterised by stage
count, CBAM attention and dilation.  None is used by a shipped config; in
the JAX package they build as a ``Detector1stage`` correlator (one map
out), and so they do here.  NCHW; flax module names (``block{s}_conv``,
``block{s}_res{r}.conv1``, ``up{s}``, ...), as no torch reference is at
hand.

The up-paths are flax's ``nn.ConvTranspose(strides=(s, s), padding=
"SAME")``, which is ``lax.conv_transpose`` with the kernel NOT flipped
(``transpose_kernel=False``): the input dilated by the stride, padded by
``lax``'s own SAME rule, then a plain convolution with the kernel as it
is.  ``nn.ConvTranspose2d`` is the adjoint of a convolution (a flipped
kernel, other padding), so ``ConvTransposeSame`` transcribes the ``lax``
arithmetic instead.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..registry import BACKBONE
from .norm import BatchNorm2d

BN_MOMENTUM = 0.1  # flax momentum 0.9
BN_EPS = 1e-5


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def conv_transpose_same_padding(k: int, s: int):
    """``lax``'s (before, after) padding of a SAME transposed convolution
    of kernel ``k`` and stride ``s`` (`jax/_src/lax/convolution.py::
    _conv_transpose_padding`): the output is ``s`` times the input."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


class ConvTransposeSame(nn.Conv2d):
    """flax ``nn.ConvTranspose(features, (k, k), strides=(s, s),
    padding="SAME")``: the weight is the flax kernel in torch's OIHW
    layout, applied unflipped to the stride-dilated, SAME-padded input.  A
    ``Conv2d`` by its parameters, so checkpoints and ``init_weights`` treat
    it as one."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int):
        super().__init__(in_channels, out_channels, kernel_size)
        self.up = stride
        self.pads = conv_transpose_same_padding(kernel_size, stride)

    def forward(self, x):
        s = self.up
        if s > 1:
            B, C, H, W = x.shape
            d = x.new_zeros(B, C, (H - 1) * s + 1, (W - 1) * s + 1)
            d[:, :, ::s, ::s] = x
            x = d
        a, b = self.pads
        return F.conv2d(F.pad(x, (a, b, a, b)), self.weight, self.bias)


class PlainResidualBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn1 = _bn(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn2 = _bn(channels)

    def forward(self, x):
        # the reference applies no activation here
        return x + self.bn2(self.conv2(self.bn1(self.conv1(x))))


class CBAMBlock(nn.Module):
    """Conv + channel/spatial attention (reference
    `ResidualBlockCBAM:33-59`)."""

    def __init__(self, channels: int, r: float = 0.5):
        super().__init__()
        hidden = int(channels * r)
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.mlp1 = nn.Linear(channels, hidden)
        self.mlp2 = nn.Linear(hidden, channels)
        self.conv_cbam = nn.Conv2d(2, 1, 7, padding=3)

    def forward(self, x):
        x = self.conv1(x)

        def mlp(v):
            return self.mlp2(F.relu(self.mlp1(v)))
        fc = torch.sigmoid(mlp(x.mean(dim=(2, 3))) + mlp(x.amax(dim=(2, 3))))
        xc = x * fc[:, :, None, None]
        fs = torch.sigmoid(self.conv_cbam(torch.cat(
            [xc.mean(dim=1, keepdim=True), xc.amax(dim=1, keepdim=True)],
            dim=1)))
        return x + xc * fs


class ResnetFPNFamily(nn.Module):
    """``n_stages`` conv stages (stride 2 after the first, widening x2 at
    stages 3-4; the dilated variants keep stride 1 and dilation 2 after
    stage 0) with transposed-conv up-paths concatenated at the first
    stage's resolution."""

    def __init__(self, num_channels: int, n_stages: int = 5,
                 use_cbam: bool = False, dilated: bool = False,
                 in_channels: int = 64):
        super().__init__()
        c = num_channels
        widths = [c, c, 2 * c, 4 * c, 4 * c][:n_stages]
        up_widths = [2 * c, 2 * c, 2 * c, 4 * c, 4 * c][:n_stages]
        Block = CBAMBlock if use_cbam else PlainResidualBlock
        self.n_stages = n_stages
        scale, prev = 1, in_channels
        for s in range(n_stages):
            d = 2 if (dilated and s > 0) else 1
            stride = 1 if (s == 0 or dilated) else 2
            setattr(self, f"block{s}_conv", nn.Conv2d(
                prev, widths[s], 3, stride=stride, padding=d, dilation=d))
            setattr(self, f"block{s}_bn", _bn(widths[s]))
            for r in range(1 if s == 0 else 2):
                setattr(self, f"block{s}_res{r}", Block(widths[s]))
            if not (dilated and s > 0):
                scale = scale if s == 0 else scale * 2
            setattr(self, f"up{s}", ConvTransposeSame(widths[s], up_widths[s],
                                                      3, scale))
            prev = widths[s]

    def forward(self, x):
        outs = []
        for s in range(self.n_stages):
            x = getattr(self, f"block{s}_conv")(x)
            x = getattr(self, f"block{s}_bn")(x)
            for r in range(1 if s == 0 else 2):
                x = getattr(self, f"block{s}_res{r}")(x)
            outs.append(getattr(self, f"up{s}")(x))
        return torch.cat(outs, dim=1)


# registered name -> (n_stages, use_cbam, dilated)
FAMILY = {"ResnetFPN": (5, False, False), "ResnetFPN2": (2, False, False),
          "ResnetFPN3": (3, False, False), "ResnetFPN4": (4, False, False),
          "ResnetFPN3_CBAM": (3, True, False),
          "ResnetFPN4_CBAM": (4, True, False),
          "ResnetFPN2_Dilated": (2, False, True),
          "ResnetFPN3_Dilated": (3, False, True),
          "ResnetFPN4_Dilated": (4, False, True)}


def family_out_channels(name: str, num_channels: int = 64) -> int:
    """Channels of the concatenated up-paths of a family backbone."""
    c = num_channels
    return sum([2 * c, 2 * c, 2 * c, 4 * c, 4 * c][:FAMILY[name][0]])


def _family_factory(n_stages, use_cbam, dilated):
    def build(cfg=None, num_channels=64, **kw):
        # flax infers the input width; here it is the encoder's fea_down
        # (the config's featuremap_out_channel)
        in_ch = cfg.get("featuremap_out_channel", 64) if cfg is not None \
            else 64
        return ResnetFPNFamily(num_channels=num_channels, n_stages=n_stages,
                               use_cbam=use_cbam, dilated=dilated,
                               in_channels=in_ch)
    return build


for _name, _args in FAMILY.items():
    BACKBONE.register_module(_family_factory(*_args), name=_name)
