"""Pre-norm ViT blocks (port of `lanemapping_tpu/models/transformer.py`).

Module and parameter names are the reference's
(`backbone/vitsegnet.py:20-83`): ``layers.{d}.0`` is PreNorm(Attention),
``layers.{d}.1`` PreNorm(FeedForward), so a reference checkpoint loads with
a plain ``load_state_dict``.  The math follows the JAX package, which is the
port's reference: LayerNorm eps 1e-6 (flax's default) and the tanh GELU
(flax's ``nn.gelu``); the attention logits and softmax are float32 whatever
the working dtype, as `transformer.py:48-52` there.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .norm import Dropout

LN_EPS = 1e-6  # flax nn.LayerNorm default


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        # net.1 is the GELU (applied functionally below), net.2/4 dropouts
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim), nn.Identity(),
                                 Dropout(dropout),
                                 nn.Linear(hidden_dim, dim),
                                 Dropout(dropout))

    def forward(self, x):
        y = F.gelu(self.net[0](x), approximate="tanh")
        y = self.net[2](y)
        return self.net[4](self.net[3](y))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.scale = dim_head ** -0.5
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.project_out = not (heads == 1 and dim_head == dim)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), Dropout(dropout)) \
            if self.project_out else nn.Identity()

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in (q, k, v))
        # explicit matmul: float32 logits and softmax, probabilities back in
        # the working dtype for the value product
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * self.scale
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(attn, v)
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        return self.to_out(out)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class Transformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([
                PreNorm(dim, Attention(dim, heads, dim_head, dropout)),
                PreNorm(dim, FeedForward(dim, mlp_dim, dropout))])
            for _ in range(depth)])

    def forward(self, x):
        for attn, ff in self.layers:
            x = x + attn(x)
            x = x + ff(x)
        return x
