"""The port's normalisations on the CPU against float64, at one and at
eight intra-op threads.

PyTorch's CPU batch norm keeps one float32 running sum per thread for a
channels-last input (the port's NHWC activations) and for an [N, C] one,
and so does its group norm for a channels-last input: their statistics and
backward sums drift from float64 as the thread count falls.  On the
channels-last [2, 32, 576, 576] input below the batch norm's output sits
1.05e-4 from float64 at one thread and 4.8e-6 at eight, where the
contiguous NCHW kernel's sits at 1.1e-7 at both (``__main__`` prints
these figures).  In training on
the CPU the port's ``BatchNorm1d``/``BatchNorm2d`` and ``GroupNorm``
normalise with ``torch.var_mean``'s statistics and sum their backward pass
in float64 (`models/norm.py`).

Each figure (the output, the batch statistics, the input, weight and bias
gradients) must be no further from float64 than PyTorch's kernel on a
contiguous input: at most twice its relative L2 distance + 1e-7 (d(weight)
is a sum with cancellation, 7e-8 to 3e-6 from float64 even on the
contiguous kernel), and the figures must be the same bits at both counts.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_port_golden as G
from lanemapping_tpu_torch.models.norm import (BatchNorm1d, BatchNorm2d,
                                               GroupNorm)

EPS = 1e-5
SLOPE, FLOOR = 2.0, 1e-7


def draw(shape, seed=0):
    """x with per-channel offsets and scales (a conv's output), a
    cotangent dy, the layer's weights and biases; float32 numpy."""
    rng = np.random.RandomState(seed)
    c = shape[1]
    per_c = [1, c] + [1] * (len(shape) - 2)
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 3.0, c).reshape(per_c)
         + rng.uniform(-2.0, 5.0, c).reshape(per_c))
    return {"x": x.astype(np.float32),
            "dy": rng.standard_normal(shape).astype(np.float32),
            "w": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "b": rng.normal(0.0, 1.0, c).astype(np.float32)}


def layout(a: np.ndarray, channels_last: bool) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.contiguous(memory_format=torch.channels_last) \
        if channels_last else t


def leaves(d, channels_last, dtype=torch.float32):
    return (layout(d["x"], channels_last).to(dtype).requires_grad_(),
            torch.from_numpy(d["w"]).to(dtype).requires_grad_(),
            torch.from_numpy(d["b"]).to(dtype).requires_grad_())


def grouped_stats(x, groups):
    """(mean, biased var) of each (sample, group), keepdim on the grouped
    view [N, G, C/G, ...]."""
    g = x.reshape(x.shape[0], groups, -1, *x.shape[2:])
    var, mean = torch.var_mean(g, dim=tuple(range(2, g.dim())),
                               correction=0, keepdim=True)
    return g, mean, var


def reference(d, groups):
    """flax's BatchNorm in training (``groups`` None) or GroupNorm in
    float64, differentiated."""
    x, w, b = leaves(d, False, torch.float64)
    shape = [1, -1] + [1] * (x.dim() - 2)
    if groups is None:
        dims = [0] + list(range(2, x.dim()))
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        xhat = (x - mean.view(shape)) * torch.rsqrt(var + EPS).view(shape)
    else:
        g, mean, var = grouped_stats(x, groups)
        xhat = ((g - mean) * torch.rsqrt(var + EPS)).reshape(x.shape)
    y = xhat * w.view(shape) + b.view(shape)
    y.backward(torch.from_numpy(d["dy"]).double())
    return {"y": y, "mean": mean.flatten(), "var": var.flatten(),
            "dx": x.grad, "dw": w.grad, "db": b.grad}


def contiguous_kernel(d, groups):
    """PyTorch's kernel on a contiguous input (an [N, C] one as [1, C, N]:
    the batch norm takes its one-sum-per-thread path for any input of one
    element a (sample, channel)).  The batch statistics from its running
    buffers at momentum 1 (it keeps the unbiased variance); the group
    statistics from ``native_group_norm``'s mean and inverse std."""
    x, w, b = leaves(d, False)
    n = x.numel() // x.shape[1]
    if groups is None:
        rm, rv = torch.zeros(x.shape[1]), torch.ones(x.shape[1])
        flat = x.dim() == 2
        y = F.batch_norm(x.t().unsqueeze(0).contiguous() if flat else x,
                         rm, rv, w, b, training=True, momentum=1.0, eps=EPS)
        y = y[0].t() if flat else y
        mean, var = rm, rv.double() * ((n - 1) / n)
    else:
        n, c = x.shape[:2]
        y, mean, rstd = torch.native_group_norm(
            x, w, b, n, c, x[0, 0].numel(), groups, EPS)
        mean, var = mean.flatten(), rstd.double().flatten() ** -2 - EPS
    y.backward(torch.from_numpy(d["dy"]))
    return {"y": y, "mean": mean, "var": var, "dx": x.grad, "dw": w.grad,
            "db": b.grad}


def port(d, make, channels_last, groups):
    """The port's layer; the batch statistics from its running buffers at
    momentum 1, the group statistics recomputed as the layer does."""
    layer = make()
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(d["w"]))
        layer.bias.copy_(torch.from_numpy(d["b"]))
    x = layout(d["x"], channels_last).requires_grad_()
    y = layer(x)
    y.backward(layout(d["dy"], channels_last))
    if groups is None:
        mean, var = layer.running_mean.clone(), layer.running_var.clone()
    else:
        _, mean, var = grouped_stats(x.detach(), groups)
    assert y.is_contiguous(memory_format=torch.channels_last) \
        or not channels_last
    return {"y": y.detach(), "mean": mean.flatten(), "var": var.flatten(),
            "dx": x.grad, "dw": layer.weight.grad, "db": layer.bias.grad}


def distances(got, ref):
    return {k: float((got[k].detach().double() - ref[k].detach()).norm()
                     / ref[k].detach().norm()) for k in ref}


CASES = {
    # the LiDAR encoder's stem BatchNorm at T3's shape, channels-last
    "batchnorm2d_channels_last": (
        lambda: BatchNorm2d(32, eps=EPS, momentum=1.0).train(),
        (2, 32, 576, 576), True, None),
    # the column head's BatchNorm1d over the flattened tokens of the
    # flagship at batch 2 (72 proposals x 144 rows), [N, C]
    "batchnorm1d_rows": (
        lambda: BatchNorm1d(100, eps=EPS, momentum=1.0).train(),
        (2 * 72 * 144, 100), False, None),
    # the FPN's semantic-pyramid GroupNorm (one channel a group) on the
    # flagship's p2 maps at batch 2, channels-last
    "groupnorm_channels_last": (
        lambda: GroupNorm(64, 64, eps=EPS).train(), (2, 64, 288, 288), True,
        64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_norm_is_as_near_float64_as_the_contiguous_kernel(case):
    make, shape, channels_last, groups = CASES[case]
    d = draw(shape)
    ref = reference(d, groups)
    runs = {}
    for threads in (1, 8):
        with G.threads(threads):
            d_kernel = distances(contiguous_kernel(d, groups), ref)
            runs[threads] = port(d, make, channels_last, groups)
        d_port = distances(runs[threads], ref)
        for k in ref:
            assert d_port[k] <= SLOPE * d_kernel[k] + FLOOR, (
                f"{case} at {threads} threads: {k} {d_port[k]:.3e} from "
                f"float64, the contiguous kernel {d_kernel[k]:.3e}")
    for k in ref:
        assert torch.equal(runs[1][k], runs[8][k]), f"{case}: {k} moves " \
            "with the thread count"


def test_op_sweep_flags_the_kernel_that_moves_with_the_thread_count():
    """The thread sweep's op-by-op half (`torch_port_golden.op_sweep`), at
    one thread against eight: PyTorch's channels-last batch norm moves,
    forward and backward; nothing of the port's BatchNorm2d does."""
    d = draw((2, 32, 128, 128))
    x, w, b = leaves(d, True)
    dy = layout(d["dy"], True)
    bn = BatchNorm2d(32, eps=EPS).train()

    def plain():
        F.batch_norm(x, None, None, w, b, training=True,
                     eps=EPS).backward(dy)

    with G.threads(1):
        flagged = {r["op"] for r in G.op_sweep(plain, 8)}
        assert G.op_sweep(lambda: bn(x).backward(dy), 8) == []
    assert {"aten.native_batch_norm.default",
            "aten.native_batch_norm_backward.default"} <= flagged


def timing(shape=(2, 32, 576, 576), counts=(1, 8), reps=3):
    """Seconds of one training forward and backward of a BatchNorm, median
    of ``reps``, at each thread count: the port's ``BatchNorm2d``
    (statistics of ``torch.var_mean``, sums in float64), PyTorch's kernel
    on the channels-last input (the layer before the repair) and on a
    contiguous copy returned channels-last (the repair not taken)."""
    import time
    d = draw(shape)
    bn = BatchNorm2d(shape[1], eps=EPS).train()

    def kernel(x, copy):
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=[0, 2, 3], correction=0)
            bn.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            bn.running_var.mul_(0.9).add_(var, alpha=0.1)
        y = F.batch_norm(x.contiguous() if copy else x, None, None,
                         bn.weight, bn.bias, training=True, eps=EPS)
        return y.contiguous(memory_format=torch.channels_last)

    ways = {"port": bn, "channels_last_kernel": lambda x: kernel(x, False),
            "contiguous_copy": lambda x: kernel(x, True)}
    rows = []
    for n in counts:
        with G.threads(n):
            for name, f in ways.items():
                fwd, bwd = [], []
                for _ in range(reps):
                    x = layout(d["x"], True).requires_grad_()
                    t0 = time.perf_counter()
                    y = f(x)
                    t1 = time.perf_counter()
                    y.backward(layout(d["dy"], True))
                    t2 = time.perf_counter()
                    fwd.append(t1 - t0)
                    bwd.append(t2 - t1)
                rows.append({"threads": n, "way": name,
                             "forward_s": float(np.median(fwd)),
                             "backward_s": float(np.median(bwd))})
    return rows


if __name__ == "__main__":
    # PYTHONPATH=.:tests python tests/test_torch_port_cpu_norms.py: the
    # figures of each case and the BatchNorm's timing table
    import json
    for case, (make, shape, channels_last, groups) in sorted(CASES.items()):
        d = draw(shape)
        ref = reference(d, groups)
        for threads in (1, 8):
            with G.threads(threads):
                print(json.dumps({
                    "case": case, "threads": threads,
                    "port": distances(port(d, make, channels_last, groups),
                                      ref),
                    "contiguous_kernel": distances(
                        contiguous_kernel(d, groups), ref)}))
    for row in timing():
        print(json.dumps(row))
