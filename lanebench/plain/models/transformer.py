"""Pre-norm ViT blocks (port of `lanemapping_tpu/models/transformer.py`).

Module and parameter names are the reference's
(`backbone/vitsegnet.py:20-83`): ``layers.{d}.0`` is PreNorm(Attention),
``layers.{d}.1`` PreNorm(FeedForward), so a reference checkpoint loads with
a plain ``load_state_dict``.  The math follows the JAX package, which is the
port's reference: LayerNorm eps 1e-6 (flax's default) and the tanh GELU
(flax's ``nn.gelu``); the attention logits and softmax are float32 whatever
the working dtype, as `transformer.py:48-52` there.  ``CrossAttention``
(the column head's query decoder) keeps flax's own attention module's
names and arithmetic instead.
"""

from __future__ import annotations

import math

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


class DenseGeneral(nn.Module):
    """flax's ``nn.DenseGeneral`` with its kernel in flax's layout
    ``in_shape + out_shape`` (contracting the trailing ``in_shape`` axes
    of the input) and a bias of ``out_shape``."""

    def __init__(self, in_shape: tuple, out_shape: tuple):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.fan_in = math.prod(self.in_shape)
        self.weight = nn.Parameter(torch.empty(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.zeros(*out_shape))

    def forward(self, x):
        lead = x.shape[:x.dim() - len(self.in_shape)]
        y = x.reshape(*lead, self.fan_in) \
            @ self.weight.reshape(self.fan_in, -1)
        return y.reshape(*lead, *self.out_shape) + self.bias


class CrossAttention(nn.Module):
    """Multi-head cross-attention with the semantics of flax 0.12.3's
    ``nn.MultiHeadDotProductAttention`` at its defaults (no dropout, no
    mask), which the JAX query decoder runs (`column_head.py:293-298`
    there): ``query``, ``key``, ``value`` are DenseGeneral kernels
    [dim, heads, dim_head], ``out`` one [heads, dim_head, out_dim].  Unlike
    ``Attention`` above, everything stays in the input dtype: the query is
    divided by ``sqrt(dim_head)`` rounded to that dtype before the product,
    and the softmax runs in that dtype (flax's
    ``force_fp32_for_softmax=False``), so in bf16 on a bf16 config.
    Explicit matmuls, so the precision is the one chosen here."""

    def __init__(self, dim: int, heads: int, dim_head: int, out_dim: int):
        super().__init__()
        self.dim_head = dim_head
        self.query = DenseGeneral((dim,), (heads, dim_head))
        self.key = DenseGeneral((dim,), (heads, dim_head))
        self.value = DenseGeneral((dim,), (heads, dim_head))
        self.out = DenseGeneral((heads, dim_head), (out_dim,))

    def forward(self, x, kv):
        q, k, v = (t.transpose(1, 2) for t in (
            self.query(x), self.key(kv), self.value(kv)))  # [B,H,N,D]
        # the divisor stays a CPU scalar: a tensor made on the card would be
        # a host-to-device copy, which waits for the card mid-forward.  On
        # the card PyTorch multiplies by its float32 reciprocal, exact when
        # dim_head is a power of 4 (16 and 64, the widths in use)
        q = q / torch.tensor(math.sqrt(self.dim_head), dtype=q.dtype)
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
        return self.out(torch.matmul(attn, v).transpose(1, 2))
