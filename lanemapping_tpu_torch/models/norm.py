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

``Dropout`` draws its mask from ``generator`` when one is set (the Runner
sets the train state's generator, seeded from ``cfg.seed``), else from
torch's default generator.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class _FlaxBatchNorm(nn.modules.batchnorm._BatchNorm):
    frozen_stats = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
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
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Point every ``Dropout`` of ``model`` at ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
