"""The frozen FLOP and byte counts against hand sums from shapes."""

import json
import os

import torch
import torch.nn as nn

from conftest import HERE, ROOT


def test_binning_bytes_are_hand_sums():
    from lanebench import flops
    B, N, C = 8, 1 << 19, 4
    # points and mask in, mean and count out: PERF.md's K1 bound 0.0466 ms
    k1 = B * N * (C * 4 + 1) + 2 * B * 1152 * 1152 * 4
    assert flops.k1_bytes(B, N, C, 1152) == k1 == 156_237_824
    assert abs(k1 / 3.35e12 * 1e3 - 0.0466) < 5e-5
    # points and mask in, the [B, 576, 576, 10 * 4] means out: 0.1481 ms
    k1z = B * N * (C * 4 + 1) + B * 576 * 576 * 10 * C * 4
    assert flops.k1z_bytes(B, N, C, (576, 576, 10)) == k1z
    assert abs(k1z / 3.35e12 * 1e3 - 0.1481) < 5e-5


def _conv_hand_sum(model, inp):
    """2 * multiply-adds of every convolution, from its shapes."""
    total = [0]

    def hook(m, a, out):
        k = m.weight.shape
        total[0] += 2 * out.numel() * k[1] * (k[2] * k[3] if len(k) == 4
                                              else k[2])
    hs = [m.register_forward_hook(hook) for m in model.modules()
          if isinstance(m, (nn.Conv1d, nn.Conv2d))]
    with torch.no_grad():
        model(inp)
    for h in hs:
        h.remove()
    return total[0]


def test_convolution_flops_match_a_hand_sum_at_tiny_size():
    from torch.utils.flop_counter import FlopCounterMode

    from lanebench.plain import build_model
    with open(os.path.join(HERE, "tiny_flagship.json")) as f:
        cfg = json.load(f)
    model = build_model(cfg)
    inp = torch.zeros((1, 192, 192, 3))
    hand = _conv_hand_sum(model, inp)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(inp)
    counted = sum(v for k, v in fc.get_flop_counts()["Global"].items()
                  if "convolution" in str(k))
    assert counted == hand > 0


def test_the_flagship_step_count_is_the_programs_published_one():
    """19,356,954,708,096 FLOPs a flagship step at batch 8: the count the
    program's own counter gives, here taken on the frozen
    plain model; 0.8078 TFLOP a served tile."""
    from lanebench.flops import model_flops
    with open(os.path.join(ROOT, "lanebench", "configs",
                           "flagship.json")) as f:
        cfg = json.load(f)
    assert model_flops(cfg, 8, True) == 19_356_954_708_096
    assert model_flops(cfg, 1, False) == 807_847_916_544
