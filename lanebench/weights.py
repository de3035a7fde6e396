"""Seeded random weights, drawn on the device in two large calls.

The rule is the program's initialisation rule, frozen here: PyTorch's
default uniform ranges (bound 1/sqrt(fan_in)) for the weights and biases
of convolutions, linears and the flax-layout ``DenseGeneral`` kernels;
unit scale and zero shift for the norms; unit normal for the position,
lane, proposal and query embeddings; N(0, 0.02^2) for ``img_pe`` and
``rel_bias``; BatchNorm running statistics at (0, 1).  The module tree
that decides which rule a leaf takes is the plain reference's
(`lanebench/plain`), which has the program's names, so one state dict
loads into both.
"""

from __future__ import annotations

import re
from typing import Dict

import torch
import torch.nn as nn

from .inputs import generator

EMBEDDINGS = ("pos_embedding", "lane_emb", "query_embed", "prop_emb")
SMALL_NORMAL = ("img_pe", "rel_bias")


def draw_state_dict(model: nn.Module, seed: int, device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """The state dict of ``model`` (the plain reference) with seeded values
    on ``device``, float32."""
    from .plain.models.transformer import DenseGeneral

    bound: Dict[str, float] = {}
    fixed: Dict[str, float] = {}
    for mname, m in model.named_modules():
        pre = mname + "." if mname else ""
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear, DenseGeneral)):
            fan_in = m.fan_in if isinstance(m, DenseGeneral) \
                else m.weight[0].numel()
            bound[pre + "weight"] = fan_in ** -0.5
            if m.bias is not None:
                bound[pre + "bias"] = fan_in ** -0.5
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d, nn.GroupNorm,
                            nn.LayerNorm)):
            fixed[pre + "weight"] = 1.0
            fixed[pre + "bias"] = 0.0
    sd = model.state_dict()
    normal = {}
    for name in sd:
        leaf = name.rsplit(".", 1)[-1]
        if leaf in EMBEDDINGS or re.fullmatch(r"emb_\d+", leaf):
            normal[name] = 1.0
        elif leaf in SMALL_NORMAL:
            normal[name] = 0.02
    missing = [n for n, _ in model.named_parameters()
               if n not in bound and n not in fixed and n not in normal]
    if missing:
        raise KeyError(f"no initialisation rule for {missing[:5]}")
    g = generator(device, seed, 0)
    uni = [n for n in sd if n in bound]
    nrm = [n for n in sd if n in normal]
    flat_u = torch.rand(sum(sd[n].numel() for n in uni), generator=g,
                        device=device)
    flat_n = torch.randn(sum(sd[n].numel() for n in nrm), generator=g,
                         device=device)
    out: Dict[str, torch.Tensor] = {}
    for names, flat, scale in ((uni, flat_u, bound), (nrm, flat_n, normal)):
        parts = flat.split([sd[n].numel() for n in names])
        for n, p in zip(names, parts):
            v = p.view(sd[n].shape)
            out[n] = (v * 2.0 - 1.0) * scale[n] if flat is flat_u \
                else v * scale[n]
    for n, t in sd.items():
        if n in out:
            continue
        if n in fixed:
            out[n] = torch.full(t.shape, fixed[n], device=device)
        elif n.endswith("running_var"):
            out[n] = torch.ones(t.shape, device=device)
        else:  # running means, batch counters
            out[n] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    return out
