"""Global feature correlator VitSegNet ("GFC-T"), port of
`lanemapping_tpu/models/vit.py` (reference `backbone/vitsegnet.py:132-214`).

8x8 patch embedding over the S x S x C encoder map -> (S/8)^2 tokens,
learned position embedding, no class token, pre-norm ViT, un-patch back to
S x S x dim/64.  Layout NCHW; the patch flattening keeps the reference's
(p1 p2 c) channel order.  MixSegNet and Dummy wait for a later slice.
"""

from __future__ import annotations

import inspect

import torch
import torch.nn as nn

from ..registry import BACKBONE
from .norm import Dropout
from .transformer import Transformer


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


@BACKBONE.register_module(name="VitSegNet")
def build_vitsegnet(cfg=None, **kw):
    fields = inspect.signature(VitSegNet).parameters
    return VitSegNet(**{k: v for k, v in kw.items() if k in fields})
