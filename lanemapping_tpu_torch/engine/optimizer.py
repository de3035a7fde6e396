"""Optimizer and learning-rate schedule from a config (port of
`lanemapping_tpu/engine/optimizer.py`).

The JAX package builds optax transforms; here they are ``torch.optim``
optimizers, whose Adam, AdamW (decoupled decay, default 1e-2) and
momentum-SGD updates are optax's formulas, driven by a ``LambdaLR`` whose
factor is the optax schedule.  optax evaluates the schedule at the update
count before it increments; ``LambdaLR`` sets ``lambda(k)`` before update
k as long as ``scheduler.step()`` follows every applied update, which the
train step does (a step the NaN guard skips advances neither).

Schedules (``build_schedule``, a function of the step):

- ``CosineAnnealingLR``: optax's ``cosine_decay_schedule`` with ``alpha =
  eta_min / lr``, flat at its floor after ``T_max`` (torch's own
  ``CosineAnnealingLR`` would climb again);
- ``LambdaLR``: ``lr * gamma ** (step // steps_per_epoch)``;
- SGD adds a linear warm-up 0 -> 1 over 5000 steps.

``optimizer.mu_dtype`` (a bf16 first moment) is not ported and is refused.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

SGD_WARMUP_STEPS = 5000


def build_schedule(cfg) -> Callable[[int], float]:
    base_lr = cfg.optimizer.lr
    sch = cfg.get("scheduler", None)
    if sch is None:
        return lambda step: base_lr
    if sch.type == "CosineAnnealingLR":
        decay_steps = max(1, sch.T_max)
        alpha = sch.get("eta_min", 0.0) / base_lr if base_lr else 0.0

        def cosine(step):
            t = min(step, decay_steps)
            c = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
            return base_lr * ((1.0 - alpha) * c + alpha)
        return cosine
    if sch.type == "LambdaLR":
        gamma = sch.get("gamma", 0.95)
        steps_per_epoch = sch.get("steps_per_epoch", 1)
        return lambda step: base_lr * gamma ** (step // steps_per_epoch)
    raise KeyError(f"unknown scheduler {sch.type}")


def build_optimizer(cfg, params):
    """(optimizer, ``LambdaLR`` scheduler) over ``params``."""
    if cfg.optimizer.get("mu_dtype", None) is not None:
        raise NotImplementedError(
            "optimizer.mu_dtype is not ported to lanemapping_tpu_torch")
    schedule = build_schedule(cfg)
    base_lr = cfg.optimizer.lr
    opt_type = cfg.optimizer.type
    if opt_type == "Adam":
        opt = torch.optim.Adam(params, lr=base_lr)
    elif opt_type == "AdamW":
        opt = torch.optim.AdamW(
            params, lr=base_lr,
            weight_decay=cfg.optimizer.get("weight_decay", 1e-2))
    elif opt_type == "SGD":
        opt = torch.optim.SGD(params, lr=base_lr,
                              momentum=cfg.optimizer.get("momentum", 0.9))
        lr_fn = schedule
        schedule = lambda step: lr_fn(step) * min(  # noqa: E731
            step, SGD_WARMUP_STEPS) / SGD_WARMUP_STEPS
    else:
        raise KeyError(f"unknown optimizer {opt_type}")
    if base_lr:
        factor = lambda step: schedule(step) / base_lr  # noqa: E731
    else:
        factor = lambda step: 0.0  # noqa: E731
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
