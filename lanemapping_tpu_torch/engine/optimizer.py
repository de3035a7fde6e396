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

``optimizer.mu_dtype`` (a bf16 first moment, optax's ``mu_dtype``) takes
``MuDtypeAdam``, a small optimizer that follows optax's ``scale_by_adam``
step by step; without it the shipped configs keep ``torch.optim``'s.
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


class MuDtypeAdam(torch.optim.Optimizer):
    """Adam, or AdamW with ``weight_decay``, as optax computes them with
    ``mu_dtype`` (`optax/_src/transform.py::scale_by_adam`): the first
    moment is stored in ``mu_dtype``, the second in float32.  Per step,
    with g the float32 gradient:

    - ``mu = (1 - b1) * g + b1 * mu_stored`` in float32, ``b1`` rounded to
      ``mu_dtype`` first: JAX casts a Python float to the dtype of the
      bf16 array it multiplies (0.9 becomes 0.8984375), and the jitted
      step (XLA) keeps the product in float32, where an eager JAX call
      would round it to bf16; ``nu = (1 - b2) * g^2 + b2 * nu``;
    - the update ``mu / bc1 / (sqrt(nu / bc2) + eps)`` from the float32
      moment, ``bc = 1 - b^count`` with the divisors in float32; AdamW adds
      ``weight_decay * p``; then ``p - lr * update``;
    - only then is ``mu`` cast to ``mu_dtype`` and stored.

    The state keys are ``torch.optim.Adam``'s (``step``, ``exp_avg``,
    ``exp_avg_sq``), so checkpoints and ``tools/from_jax`` treat both
    alike.  Each arithmetic step is one ``torch._foreach_*`` call over
    every parameter of a group, in the order written above, so each
    float32 rounding is the per-tensor formula's."""

    def __init__(self, params, lr: float, mu_dtype: torch.dtype,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                st["step"] += 1.0
            ts = [float(st["step"]) for st in states]  # CPU: no device sync
            g = [p.grad.float() for p in params]
            mu = torch._foreach_mul([st["exp_avg"].float() for st in states],
                                    b1_mu)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
            gg = torch._foreach_mul(g, g)
            torch._foreach_mul_(gg, 1.0 - b2)
            nu = torch._foreach_mul([st["exp_avg_sq"] for st in states], b2)
            torch._foreach_add_(nu, gg)
            u = torch._foreach_div(mu, [1.0 - b1 ** t for t in ts])
            den = torch._foreach_div(nu, [1.0 - b2 ** t for t in ts])
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            torch._foreach_div_(u, den)
            if wd:
                torch._foreach_add_(u, torch._foreach_mul(params, wd))
            torch._foreach_mul_(u, lr)
            torch._foreach_sub_(params, u)
            for st, m, n in zip(states, mu, nu):
                st["exp_avg"] = m.to(self.mu_dtype)
                st["exp_avg_sq"] = n
        return None


def build_optimizer(cfg, params):
    """(optimizer, ``LambdaLR`` scheduler) over ``params``."""
    schedule = build_schedule(cfg)
    base_lr = cfg.optimizer.lr
    opt_type = cfg.optimizer.type
    mu_dtype = cfg.optimizer.get("mu_dtype", None)
    wd = cfg.optimizer.get("weight_decay", 1e-2)
    if mu_dtype is not None:
        # jnp.dtype refuses a name that is not a dtype the same way
        mu_dtype = getattr(torch, str(mu_dtype), None)
        if not isinstance(mu_dtype, torch.dtype):
            raise TypeError(f"optimizer.mu_dtype="
                            f"{cfg.optimizer.mu_dtype!r} names no dtype")
    if mu_dtype is not None and opt_type in ("Adam", "AdamW"):
        opt = MuDtypeAdam(params, lr=base_lr, mu_dtype=mu_dtype,
                          weight_decay=wd if opt_type == "AdamW" else 0.0)
    elif opt_type == "Adam":
        opt = torch.optim.Adam(params, lr=base_lr)
    elif opt_type == "AdamW":
        opt = torch.optim.AdamW(params, lr=base_lr, weight_decay=wd)
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
