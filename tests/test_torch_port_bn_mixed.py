"""The training BatchNorm's mixed-precision pass (`models/norm.py`): on the
card a bf16 or fp16 activation is normalised with float32 weight, bias and
statistics by K2 (`kernels/batch_norm.py`) where its layout allows, else by
``torch.native_batch_norm``; it comes back in its own dtype, keeps no
float32 copy of itself for the backward pass, and moves the running
statistics toward the batch mean and biased variance.

The CPU tests reach the card's branch on the ``meta`` device, and hold the
pass's arithmetic (K2's plain versions, the library call) to float64 on the
CPU.  The card tests (marker ``cuda``) hold K2 and the library call to the
float32 path that float32 inputs take, at the flagship's BatchNorm shapes
(batch 8, channels-last bf16).  This file imports neither JAX nor the JAX
package:

    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_port_bn_mixed.py
"""

import numpy as np
import pytest
import torch

from lanemapping_tpu_torch.kernels.batch_norm import (bn_backward, bn_forward,
                                                      supported)
from lanemapping_tpu_torch.models import norm
from lanemapping_tpu_torch.models.norm import (BatchNorm1d, BatchNorm2d,
                                               batch_var_from_invstd,
                                               frozen_batch_stats)
from lanemapping_tpu_torch.utils import logger

EPS = 1e-5
BF16_STEP = 2.0 ** -8    # bf16's relative step (8 bits of mantissa)
# the flagship's BatchNorm inputs at batch 8: the stem, the four ResNet-34
# stages, the head's widest map and its row heads' [N, C] BatchNorm1d
FLAGSHIP_SHAPES = [(8, 64, 576, 576), (8, 64, 288, 288), (8, 128, 144, 144),
                   (8, 256, 144, 144), (8, 16, 288, 288), (82944, 100)]


@pytest.fixture
def rec():
    logger.reset_recorder()
    yield logger
    logger.reset_recorder()


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import, so every
    worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the mixed call runs on the card "
                    "(run `python -m pytest -m cuda` there)")
    return torch.device("cuda")


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _layer(shape, device="cpu"):
    bn = (BatchNorm2d if len(shape) == 4 else BatchNorm1d)(
        shape[1], eps=EPS, momentum=0.1)
    return bn.to(device).train()


def _activation(shape, dtype, device="cpu", seed=0):
    """A conv-like activation: per-channel offsets and scales, channels
    last where it has positions (drawn on the CPU for ``meta``)."""
    draw = "cpu" if device == "meta" else device
    g = torch.Generator(device=draw).manual_seed(seed)
    c = shape[1]
    per_c = [1, c] + [1] * (len(shape) - 2)
    scale = torch.rand(c, generator=g, device=draw) * 2.5 + 0.5
    offset = torch.rand(c, generator=g, device=draw) * 7.0 - 2.0
    x = (torch.randn(shape, generator=g, device=draw) * scale.view(per_c)
         + offset.view(per_c)).to(device, dtype)
    return x.contiguous(memory_format=torch.channels_last) \
        if len(shape) == 4 else x


# -- the card's branch, reached on `meta` ---------------------------------

@pytest.mark.parametrize("shape", [(4, 16, 12, 10), (96, 24), (6, 24, 7)],
                         ids=["nchw_channels_last", "n_c", "n_c_l"])
def test_reduced_precision_input_comes_back_in_its_dtype(rec, shape):
    bn = _layer(shape, "meta")
    x = _activation(shape, torch.float32, "meta").to(torch.bfloat16)
    with _profiled():
        y = bn(x)
        with frozen_batch_stats(bn):
            bn(x)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    if len(shape) == 4:
        assert y.is_contiguous(memory_format=torch.channels_last)
    # one mixed call a layer call, the frozen recompute's too
    assert rec.recorded()["counters"] == {"bn_mixed": 2}


@pytest.mark.parametrize("shape", [(4, 16, 12, 10), (6, 20)],
                         ids=["k2", "library"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_no_float32_copy_of_the_activation_is_saved(dtype, shape):
    bn = _layer(shape, "meta")
    x = _activation(shape, torch.float32, "meta").to(dtype).requires_grad_()
    saved = []

    def pack(t):
        saved.append((t.dtype, t.numel()))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = bn(x)
    assert (dtype, x.numel()) in saved          # the input itself
    assert (torch.float32, x.numel()) not in saved, saved
    dx, dw, db = torch.autograd.grad(y, (x, bn.weight, bn.bias),
                                     torch.ones_like(y))
    assert dx.dtype == dtype and dw.dtype == db.dtype == torch.float32


def test_float32_input_keeps_the_float32_path(rec):
    shape = (4, 16, 12, 10)
    bn = _layer(shape, "meta")
    x = _activation(shape, torch.float32, "meta").requires_grad_()
    saved = []
    with _profiled(), torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append((t.dtype, t.numel())) or t, lambda t: t):
        y = bn(x)
    assert y.dtype == torch.float32
    assert "bn_mixed" not in rec.recorded()["counters"]
    assert (torch.float32, x.numel()) in saved


def test_world_of_many_and_cpu_keep_their_paths(rec, monkeypatch):
    shape = (4, 16, 12, 10)
    x = _activation(shape, torch.bfloat16)
    with _profiled():
        y = _layer(shape)(x)                     # the CPU: `_CpuNorm`
    assert y.dtype == torch.bfloat16
    monkeypatch.setattr(norm, "get_world_size", lambda: 2)
    taken = []
    monkeypatch.setattr(norm._SyncBatchNorm, "apply",
                        lambda *a: taken.append(a[0].dtype) or (
                            a[0], a[0].mean((0, 2, 3)), a[0].var((0, 2, 3))))
    with _profiled():
        _layer(shape, "meta")(x.to("meta"))
    assert taken == [torch.float32]
    assert "bn_mixed" not in rec.recorded()["counters"]


# -- the call's arithmetic, on the CPU ------------------------------------

def test_variance_from_invstd_in_float64():
    rng = np.random.RandomState(0)
    scales = np.array([3.0, 1.0, 0.01, 3e-7])   # the last: var 1e-13 << eps
    x = torch.from_numpy(rng.standard_normal((2, 4, 50, 50))
                         * scales.reshape(1, 4, 1, 1) + 2.0)
    var, _ = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    assert var[3] < 1e-7 * EPS
    invstd = torch.rsqrt(var + EPS)
    got = batch_var_from_invstd(invstd, EPS)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, var, rtol=1e-8, atol=1e-20)
    # in float32 the channel far below eps cancels to nothing like its var
    in32 = invstd.float().pow(-2) - EPS
    assert abs(float(in32[3]) - float(var[3])) > float(var[3])
    # from a float32 invstd, as the card's call gives it: within its
    # rounding of var + eps, and never below 0
    from32 = batch_var_from_invstd(invstd.float(), EPS)
    assert torch.all(from32 >= 0)
    assert torch.all((from32 - var).abs() <= 2.0 ** -21 * (var + EPS))


def _float64_reference(x, w, b, dy):
    """flax's BatchNorm in training in float64: y, dx, dw, db, mean and the
    biased variance."""
    x64 = x.double().requires_grad_()
    w64, b64 = (t.double().requires_grad_() for t in (w, b))
    dims = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    var, mean = torch.var_mean(x64, dim=dims, correction=0)
    y = (x64 - mean.view(shape)) * torch.rsqrt(var + EPS).view(shape) \
        * w64.view(shape) + b64.view(shape)
    dx, dw, db = torch.autograd.grad(y, (x64, w64, b64), dy.double())
    return y.detach(), dx, dw, db, mean.detach(), var.detach()


def _rel_l2(a, b):
    return float(torch.linalg.vector_norm(a.double() - b.double())
                 / torch.linalg.vector_norm(b.double()))


@pytest.mark.parametrize("shape,k2", [((4, 16, 12, 10), True),
                                      ((96, 24), True), ((96, 20), False),
                                      ((6, 24, 7), False)],
                         ids=["k2_nchw", "k2_n_c", "library_n_c",
                              "library_n_c_l"])
def test_mixed_call_meets_float64_and_moves_the_stats_as_flax(rec, shape,
                                                              k2):
    """K2 (its plain versions here) where the layout allows it, else
    ``torch.native_batch_norm``."""
    bn = _layer(shape)
    x = _activation(shape, torch.bfloat16, seed=1).requires_grad_()
    assert supported(x) == k2
    dy = _activation(shape, torch.bfloat16, seed=2)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
    ref = _float64_reference(x.detach(), bn.weight.detach(),
                             bn.bias.detach(), dy)
    with _profiled():
        y = bn._normalise_mixed(x)
    assert rec.recorded()["counters"] == {"bn_mixed": 1}
    assert y.dtype == torch.bfloat16
    # one bf16 rounding of the float64 output
    step = BF16_STEP * ref[0].abs().clamp_min(2.0 ** -8)
    assert torch.all((y.double() - ref[0]).abs() <= step)
    dx, dw, db = torch.autograd.grad(y, (x, bn.weight, bn.bias), dy)
    assert dx.dtype == torch.bfloat16
    assert _rel_l2(dx, ref[1]) < BF16_STEP
    assert _rel_l2(dw, ref[2]) < BF16_STEP and _rel_l2(db, ref[3]) < BF16_STEP
    # running statistics: momentum 0.1 toward the mean and BIASED variance
    torch.testing.assert_close(bn.running_mean, (0.1 * ref[4]).float())
    torch.testing.assert_close(bn.running_var,
                               (0.9 + 0.1 * ref[5]).float())
    before = [t.clone() for t in bn.buffers()]
    with frozen_batch_stats(bn):
        y2 = bn._normalise_mixed(x)
    assert torch.equal(y2, y)
    assert all(torch.equal(a, b) for a, b in zip(bn.buffers(), before))


# -- on the card: the mixed call against the float32 path -------------------

def _card_pass(shape, device, monkeypatch, mixed):
    """y, dx, dw, db and the running statistics of one training call at the
    train step's dtypes (bf16 activation, bf16 casts of float32 masters),
    through the mixed call or the float32 path."""
    if not mixed:
        monkeypatch.setattr(norm, "MIXED_DTYPES", ())
    torch.manual_seed(0)
    bn = _layer(shape, device)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
    x = _activation(shape, torch.bfloat16, device, seed=1).requires_grad_()
    dy = _activation(shape, torch.bfloat16, device, seed=2)
    params = {"weight": bn.weight.to(torch.bfloat16),
              "bias": bn.bias.to(torch.bfloat16)}
    y = torch.func.functional_call(bn, params, (x,))
    dx, dw, db = torch.autograd.grad(y, (x, bn.weight, bn.bias), dy)
    torch.cuda.synchronize()
    monkeypatch.undo()
    return {"y": y.detach(), "dx": dx, "dw": dw, "db": db,
            "mean": bn.running_mean, "var": bn.running_var, "bn": bn,
            "x": x.detach()}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES,
                         ids=["x".join(map(str, s)) for s in FLAGSHIP_SHAPES])
def test_card_mixed_call_holds_to_the_float32_path(cuda_device, monkeypatch,
                                                   rec, shape):
    launches = bn_forward.launches, bn_backward.launches
    with _profiled():
        new = _card_pass(shape, cuda_device, monkeypatch, mixed=True)
    # K2 where C is a multiple of 8, the library's mixed call elsewhere
    k2 = int(shape[1] % 8 == 0)
    want = {"bn_mixed": 1, "bn_k2": 1} if k2 else {"bn_mixed": 1}
    assert rec.recorded()["counters"] == want
    assert bn_forward.launches - launches[0] == k2
    assert bn_backward.launches - launches[1] == k2
    old = _card_pass(shape, cuda_device, monkeypatch, mixed=False)
    assert new["y"].dtype == new["dx"].dtype == torch.bfloat16
    assert old["y"].dtype == torch.bfloat16
    # y: within one bf16 step of the float32 path's
    a, b = new["y"].float(), old["y"].float()
    big = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -8)
    step = torch.exp2(torch.floor(torch.log2(big)) - 7)
    assert torch.all((a - b).abs() <= step), float(((a - b).abs()
                                                     / step).max())
    # gradients at bf16 tolerance
    for k in ("dx", "dw", "db"):
        assert _rel_l2(new[k], old[k]) < BF16_STEP, (k, _rel_l2(new[k],
                                                                 old[k]))
    # running statistics at float32 tolerance
    torch.testing.assert_close(new["mean"], old["mean"])
    torch.testing.assert_close(new["var"], old["var"])
    # a frozen recompute leaves the buffers as they were, bit for bit
    bn = new["bn"]
    before = [t.clone() for t in bn.buffers()]
    with frozen_batch_stats(bn):
        bn(new["x"])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(bn.buffers(), before))
