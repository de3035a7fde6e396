"""Global feature correlators VitSegNet ("GFC-T"), MixSegNet and Dummy,
port of `lanemapping_tpu/models/vit.py` (reference
`backbone/vitsegnet.py:132-214`, `backbone/mixsegnet.py:13-76`,
`backbone/dummy.py`).

8x8 patch embedding over the S x S x C encoder map -> (S/8)^2 tokens; the
ViT adds a learned position embedding (no class token) and runs pre-norm
attention blocks, the MLP-Mixer ablation mixes tokens and channels with
two MLPs per block; both un-patch back to S x S x dim/64.  Layout NCHW; the
patch flattening keeps the reference's (p1 p2 c) channel order.
VitSegNet keeps the reference's torch names; MixSegNet has no torch
reference here and takes the flax module names.
"""

from __future__ import annotations

import inspect

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..registry import BACKBONE
from .norm import Dropout
from .transformer import LN_EPS, Transformer


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """NCHW [B,C,H,W] -> [B, (H/p)(W/p), p*p*C] in (p1 p2 c) order."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // p, p, w // p, p)
    x = x.permute(0, 2, 4, 3, 5, 1)  # b, h', w', p1, p2, c
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def unpatchify(x: torch.Tensor, hp: int, wp: int, p: int) -> torch.Tensor:
    """[B, hp*wp, p*p*C] -> NCHW [B, C, hp*p, wp*p] (inverse of patchify)."""
    b, n, d = x.shape
    c = d // (p * p)
    x = x.reshape(b, hp, wp, p, p, c)
    x = x.permute(0, 5, 1, 3, 2, 4)  # b, c, h', p1, w', p2
    return x.reshape(b, c, hp * p, wp * p)


class VitSegNet(nn.Module):
    def __init__(self, image_size: int = 144, patch_h_size: int = 8,
                 patch_w_size: int = 8, channels: int = 64, dim: int = 512,
                 depth: int = 3, heads: int = 16, output_channels: int = 8,
                 expansion_factor: int = 4, dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0,
                 is_with_shared_mlp: bool = False):
        super().__init__()
        p = patch_h_size
        self.patch = p
        n_tok = (image_size // p) * (image_size // p)
        # index 0 of the reference's Sequential is the Rearrange
        self.to_patch_embedding = nn.Sequential(
            nn.Identity(), nn.Linear(p * p * channels, dim))
        self.pos_embedding = nn.Parameter(torch.randn(1, n_tok, dim))
        self.dropout = Dropout(emb_dropout)
        self.transformer = Transformer(dim, depth, heads, dim_head,
                                       int(dim * expansion_factor), dropout)
        self.shared_mlp = nn.Conv2d(dim // (p * p), output_channels, 1) \
            if is_with_shared_mlp else None

    def forward(self, x):
        p = self.patch
        _, _, h, w = x.shape
        hp, wp = h // p, w // p
        tokens = self.to_patch_embedding[1](patchify(x, p))
        tokens = tokens + self.pos_embedding[:, :tokens.shape[1]]
        tokens = self.transformer(self.dropout(tokens))
        out = unpatchify(tokens, hp, wp, p)  # [B, dim/(p*p), h, w]
        if self.shared_mlp is not None:
            out = self.shared_mlp(out)
        return out


def correlator_out_channels(cfg) -> int:
    """Channels of the map a lane head reads: the correlator's un-patched
    ``dim / p^2`` (``output_channels`` with its shared MLP), or the
    encoder's ``featuremap_out_channel`` when no correlator runs (none
    configured, ``Dummy``, or ``vit_seg`` off under Detector1stage).  The
    patch is VitSegNet's ``patch_h_size`` or MixSegNet's ``patch_size``; a
    ResnetFPN-family correlator returns its concatenated up-paths.  flax
    infers these widths at init; torch needs them up front."""
    from .resnet_fpn_family import FAMILY, family_out_channels
    enc = cfg.get("featuremap_out_channel", 64)
    if "backbone" not in cfg or cfg.backbone.type == "Dummy" or (
            cfg.net.type == "Detector1stage" and not cfg.get("vit_seg", True)):
        return enc
    bb = cfg.backbone
    if bb.type in FAMILY:
        return family_out_channels(bb.type, bb.get("num_channels", 64))
    if bb.get("is_with_shared_mlp", False):
        return bb.get("output_channels", 8)
    p = bb.get("patch_h_size", bb.get("patch_size", 8))
    return bb.get("dim", 512) // (p * p)


class MixerBlock(nn.Module):
    """Token mix, then channel mix (reference `mixsegnet.py:13-31`): the
    token MLP is a linear over the transposed token axis.  The JAX block
    takes a dropout rate and applies none; neither does this one."""

    def __init__(self, num_tokens: int, dim: int, token_mlp_dim: int,
                 channel_mlp_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.token_fc1 = nn.Linear(num_tokens, token_mlp_dim)
        self.token_fc2 = nn.Linear(token_mlp_dim, num_tokens)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.chan_fc1 = nn.Linear(dim, channel_mlp_dim)
        self.chan_fc2 = nn.Linear(channel_mlp_dim, dim)

    def forward(self, x):
        y = self.norm1(x).transpose(1, 2)  # [B, dim, tokens]
        y = self.token_fc2(F.gelu(self.token_fc1(y), approximate="tanh"))
        x = x + y.transpose(1, 2)
        y = F.gelu(self.chan_fc1(self.norm2(x)), approximate="tanh")
        return x + self.chan_fc2(y)


class MixSegNet(nn.Module):
    def __init__(self, image_size: int = 144, patch_size: int = 8,
                 channels: int = 64, dim: int = 512, depth: int = 3,
                 output_channels: int = 8, expansion_factor: int = 4,
                 dropout: float = 0.0, is_with_shared_mlp: bool = False):
        super().__init__()
        del dropout  # unused by the JAX MixerBlock
        p = patch_size
        self.patch = p
        n_tok = (image_size // p) ** 2
        hidden = dim * expansion_factor
        self.patch_embed = nn.Linear(p * p * channels, dim)
        self.mixers = nn.ModuleList([MixerBlock(n_tok, dim, hidden, hidden)
                                     for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.shared_mlp = nn.Conv2d(dim // (p * p), output_channels, 1) \
            if is_with_shared_mlp else None

    def forward(self, x):
        p = self.patch
        _, _, h, w = x.shape
        tokens = self.patch_embed(patchify(x, p))
        for block in self.mixers:
            tokens = block(tokens)
        out = unpatchify(self.norm(tokens), h // p, w // p, p)
        if self.shared_mlp is not None:
            out = self.shared_mlp(out)
        return out


class Dummy(nn.Module):
    """Identity correlator for ablations (reference `backbone/dummy.py`)."""

    def forward(self, x):
        return x


@BACKBONE.register_module(name="VitSegNet")
def build_vitsegnet(cfg=None, **kw):
    fields = inspect.signature(VitSegNet).parameters
    return VitSegNet(**{k: v for k, v in kw.items() if k in fields})


@BACKBONE.register_module(name="MixSegNet")
def build_mixsegnet(cfg=None, **kw):
    fields = inspect.signature(MixSegNet).parameters
    return MixSegNet(**{k: v for k, v in kw.items() if k in fields})


@BACKBONE.register_module(name="Dummy")
def build_dummy(cfg=None, **kw):
    return Dummy()
