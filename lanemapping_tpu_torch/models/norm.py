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
  into the normalising call, so a bf16 input never meets float32 buffers
  there.

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

from ..parallel.dist import get_rank, get_world_size, sum_over_ranks


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


class _FlaxBatchNorm(nn.modules.batchnorm._BatchNorm):
    frozen_stats = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if get_world_size() > 1:
            y, mean, var = _SyncBatchNorm.apply(
                x32, self.weight.to(x32.dtype), self.bias.to(x32.dtype),
                self.eps)
            if not self.frozen_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                    self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            return y.to(x.dtype)
        dims = [0] + list(range(2, x.dim()))
        if not self.frozen_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x32, dim=dims, correction=0)
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        y = F.batch_norm(x32, None, None, self.weight.to(x32.dtype),
                         self.bias.to(x32.dtype), training=True, eps=self.eps)
        return y.to(x.dtype)


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


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
