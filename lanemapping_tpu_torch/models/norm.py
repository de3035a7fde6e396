"""BatchNorm and dropout with the JAX package's training semantics.

``BatchNorm1d`` / ``BatchNorm2d`` normalise as torch does and keep
torch's state-dict keys (``weight``, ``bias``, ``running_mean``,
``running_var``, ``num_batches_tracked``), so ``from_jax``,
``load_state_dict`` and reference ``.pth`` files load unchanged.  In
training they differ from ``nn.BatchNorm*d`` in two ways, both flax's
(`flax.linen.BatchNorm`):

- the running variance moves toward the **biased** batch variance (torch
  uses the unbiased one, n/(n-1) larger: ~0.1-0.4 % apart per step at a
  few hundred values per channel), with momentum 0.1 (flax's 0.9);
- the statistics and the normalisation run in at least float32 (a bf16
  activation comes back bf16), and the layer takes no running statistics
  into the normalising call: a bf16 input meets float32 parameters there,
  never float32 buffers.

In training on the card a bf16 or fp16 input (``MIXED_DTYPES``) is
normalised in one mixed-precision pass each way: float32 weight, bias and
statistics, the activation's dtype in and out, nothing float32 of the
activation's size cast or saved for the backward pass.  The pass is K2
(`kernels/batch_norm.py`, CUDA source `csrc/batch_norm.cu`) where the
layout allows it (channels last, C a multiple of 8), else
``torch.native_batch_norm``; the running statistics move toward its mean
and biased variance (from the library call's inverse std, ``invstd^-2 -
eps`` in float64: `batch_var_from_invstd`).  A float32 input takes
``torch.var_mean`` for the running statistics and ``F.batch_norm``.

``frozen_batch_stats`` keeps the running statistics of a module's
BatchNorms from moving (a checkpointed stage's recompute, where flax's
``nn.remat`` moves them once per step).

In a process group of more than one rank (`parallel/dist.py`) the layer
normalises in training with the statistics of the global batch, as
BatchNorm under the JAX package's pjit does: ``_SyncBatchNorm`` all-reduces
``sum(x)``, then ``sum((x - mean)^2)`` (the biased variance, in float32),
and in the backward pass ``[sum(dy), sum(dy * x_hat)]``; the running
statistics move toward the global mean and biased variance.  Only
``all_reduce`` is used, so it runs on gloo with CUDA tensors.
``nn.SyncBatchNorm`` is not used: it moves the running variance toward the
unbiased variance.  Every rank holds the same number of rows (the loaders
refuse a batch that does not divide).  Under ``frozen_batch_stats`` the
collectives still run (a recompute runs them in the backward pass, in the
same order on every rank).  At a world of one nothing of this runs.

In training on the CPU the layers do not call PyTorch's batch norm, nor
its group norm (``GroupNorm``): for a channels-last input (the port's NHWC
activations) or an [N, C] one those kernels keep one float32 running sum
per thread, so their figures move with the intra-op thread count (and the
process's history): their output sits 1e-4 from float64 at one thread
on the LiDAR stem's [2, 32, 576, 576] (`tests/test_torch_port_cpu_norms.py`).
``_CpuNorm`` normalises with the statistics of `torch.var_mean` and sums
its backward pass in float64; on the card a float32 input keeps
PyTorch's kernels.

``Dropout`` draws its mask from ``generator`` when one is set (the Runner
sets the train state's generator, seeded from ``cfg.seed``), else from
torch's default generator.  In a group of more than one rank it draws the
mask of the global batch and keeps this rank's rows, so every rank
advances the generator alike and N ranks draw what one process draws.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.batch_norm import MixedBatchNorm, supported
from ..parallel.dist import get_rank, get_world_size, sum_over_ranks
from ..utils.logger import count

# input dtypes a training BatchNorm on the card normalises in one
# mixed-precision pass (module docstring)
MIXED_DTYPES = (torch.bfloat16, torch.float16)


class _SyncBatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm over the global batch: float32 ``x`` [N, C,
    ...] -> (y, mean, biased var), the statistics over every rank's
    rows."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        count = x.numel() // x.shape[1] * get_world_size()
        mean = sum_over_ranks(x.sum(dims)) / count
        xc = x - mean.view(shape)
        var = sum_over_ranks((xc * xc).sum(dims)) / count
        invstd = torch.rsqrt(var + eps)
        xhat = xc * invstd.view(shape)
        y = xhat * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.count = count
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, weight, invstd = ctx.saved_tensors
        dims = [0] + list(range(2, dy.dim()))
        shape = [1, -1] + [1] * (dy.dim() - 2)
        # this rank's parts of d(weight) and d(bias); the train step sums
        # the gradients over the ranks
        dw, db = (dy * xhat).sum(dims), dy.sum(dims)
        g = sum_over_ranks(torch.cat([db, dw])) / ctx.count
        mean_dy, mean_dyx = g.split(db.numel())
        dx = (weight * invstd).view(shape) * (
            dy - mean_dy.view(shape) - xhat * mean_dyx.view(shape))
        return dx, dw, db, None


ROWS = 64   # positions a float32 partial sum of `channel_sums` covers


def channel_sums(t: torch.Tensor, per_sample: bool) -> torch.Tensor:
    """float64 sums of ``t`` [N, C, ...] per channel over the batch and the
    positions ([1, C]), or per sample and channel over the positions ([N,
    C]): float32 sums of ``ROWS`` positions at a time (each one thread's,
    so the same bits at any thread count), added in float64; cheaper than
    a float64 reduction of ``t``, which converts every element.  A view
    of a channels-last or [N, C] ``t``, a copy of another."""
    n, c = t.shape[:2]
    rows = t.movedim(1, -1).reshape(n if per_sample else 1, -1, c)
    k = rows.shape[1] - rows.shape[1] % ROWS
    part = rows[:, :k].reshape(rows.shape[0], -1, ROWS, c).sum(2)
    return (part.sum(1, dtype=torch.float64)
            + rows[:, k:].sum(1, dtype=torch.float64))


class _CpuNorm(torch.autograd.Function):
    """Normalisation of ``x`` [N, C, ...] on the CPU with the statistics of
    `torch.var_mean`: per channel over the batch (BatchNorm in training,
    ``groups`` None) or per sample and group (GroupNorm) -> (y, mean,
    biased var), the statistics flat.  The backward pass takes its sums
    from `channel_sums`."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, groups):
        n, c = x.shape[:2]
        if groups is None:
            v, dims = x, [0] + list(range(2, x.dim()))
        else:
            v = x.view(n, groups, -1, *x.shape[2:])
            dims = list(range(2, v.dim()))
        var, mean = torch.var_mean(v, dim=dims, correction=0, keepdim=True)
        rstd = torch.rsqrt(var + eps)
        xhat = (v - mean).mul_(rstd).view(x.shape)
        shape = [1, -1] + [1] * (x.dim() - 2)
        y = torch.addcmul(bias.view(shape), xhat, weight.view(shape))
        ctx.save_for_backward(xhat, weight, rstd)
        ctx.groups = groups
        ctx.mark_non_differentiable(mean, var)
        return y, mean.flatten(), var.flatten()

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, weight, rstd = ctx.saved_tensors
        n, c = dy.shape[:2]
        groups = ctx.groups
        per_sample = groups is not None
        s_dy = channel_sums(dy, per_sample)
        s_dyx = channel_sums(dy * xhat, per_sample)
        dw, db = s_dyx.sum(0).to(dy.dtype), s_dy.sum(0).to(dy.dtype)
        # the means of g = dy * weight and of g * xhat over each set the
        # statistics came from, and its rstd, per (sample or 1, channel)
        w64 = weight.double()
        if per_sample:
            size = c // groups * xhat[0, 0].numel()

            def per_set(s):
                return (s * w64).view(n, groups, -1).sum(2, keepdim=True) \
                    .expand(n, groups, c // groups).reshape(n, c) / size
            k = rstd.view(n, groups, 1).expand(n, groups, c // groups) \
                .reshape(n, c).double()
        else:
            size = dy.numel() // c

            def per_set(s):
                return s * w64 / size
            k = rstd.view(1, c).double()
        shape = [-1, c] + [1] * (dy.dim() - 2)
        dx = torch.addcmul((-k * per_set(s_dy)).to(dy.dtype).view(shape),
                           xhat, (-k * per_set(s_dyx)).to(dy.dtype)
                           .view(shape))
        dx.addcmul_(dy, (k * w64).to(dy.dtype).view(shape))
        return dx, dw, db, None, None


def batch_var_from_invstd(invstd: torch.Tensor, eps: float) -> torch.Tensor:
    """The biased batch variance behind a normalising call's inverse
    standard deviation, ``invstd^-2 - eps`` in float64 (in float32 a
    variance far below ``eps`` cancels), at least 0."""
    return invstd.double().pow(-2).sub_(eps).clamp_(min=0.0)


class _FlaxBatchNorm(nn.modules.batchnorm._BatchNorm):
    frozen_stats = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if x.dtype in MIXED_DTYPES and x.device.type != "cpu" \
                and get_world_size() == 1:
            return self._normalise_mixed(x)
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if get_world_size() > 1:
            y, mean, var = _SyncBatchNorm.apply(
                x32, self.weight.to(x32.dtype), self.bias.to(x32.dtype),
                self.eps)
            self._move_stats(mean, var)
            return y.to(x.dtype)
        if x.device.type == "cpu":
            # Departure from F.batch_norm (PyTorch's CPU kernel, not JAX's
            # arithmetic; module docstring): the batch statistics are
            # `torch.var_mean`'s, those the running statistics move toward
            y, mean, var = _CpuNorm.apply(
                x32, self.weight.to(x32.dtype), self.bias.to(x32.dtype),
                self.eps, None)
            self._move_stats(mean, var)
            return y.to(x.dtype)
        dims = [0] + list(range(2, x.dim()))
        if not self.frozen_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x32, dim=dims, correction=0)
                self._move_stats(mean, var)
        y = F.batch_norm(x32, None, None, self.weight.to(x32.dtype),
                         self.bias.to(x32.dtype), training=True, eps=self.eps)
        return y.to(x.dtype)

    def _normalise_mixed(self, x: torch.Tensor) -> torch.Tensor:
        """Training on the card with a bf16 or fp16 ``x``: one pass, float32
        parameters and statistics, ``x``'s dtype out; the running
        statistics move toward its mean and biased variance."""
        count("bn_mixed")
        w, b = self.weight.float(), self.bias.float()
        if supported(x):
            running = (None, None) if self.frozen_stats else (
                self.running_mean, self.running_var)
            return MixedBatchNorm.apply(x, w, b, *running, self.momentum,
                                        self.eps)
        y, mean, invstd = torch.native_batch_norm(x, w, b, None, None, True,
                                                  0.0, self.eps)
        if not self.frozen_stats:
            self._move_stats(mean, batch_var_from_invstd(invstd, self.eps))
        return y

    @torch.no_grad()
    def _move_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if not self.frozen_stats:
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm``; in training on the CPU through ``_CpuNorm`` (the
    module docstring: PyTorch's channels-last CPU kernel put the
    flagship's float32 step-0 ``semantic_seg_loss`` 5.6e-6 from float64
    at one thread).  In evaluation the CPU keeps PyTorch's kernel, as the
    card does: through ``_CpuNorm`` one FPN Seg pixel of
    `tests/test_torch_port_zoo_runner.py` changes class at a near-tie of
    two logits, where the test holds every class to the JAX package's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cpu" or not self.training or not self.affine:
            return super().forward(x)
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        return _CpuNorm.apply(x32, self.weight.to(x32.dtype),
                              self.bias.to(x32.dtype), self.eps,
                              self.num_groups)[0].to(x.dtype)


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module, frozen: bool = True):
    """Within the block, the BatchNorms of ``module`` (if ``frozen``)
    normalise with batch statistics but leave their running ones alone."""
    norms = [m for m in module.modules() if isinstance(m, _FlaxBatchNorm)]
    before = [m.frozen_stats for m in norms]
    for m in norms:
        m.frozen_stats = m.frozen_stats or frozen
    try:
        yield
    finally:
        for m, f in zip(norms, before):
            m.frozen_stats = f


class Dropout(nn.Dropout):
    generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        # the mask of the global batch, this rank's rows of it (the whole
        # mask at a world of one)
        n, rank = x.shape[0], get_rank()
        keep = torch.rand((n * get_world_size(),) + tuple(x.shape[1:]),
                          generator=self.generator, device=x.device)[
            rank * n:(rank + 1) * n] >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Point every ``Dropout`` of ``model`` at ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
