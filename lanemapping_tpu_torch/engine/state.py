"""Train state and the training step (port of
`lanemapping_tpu/engine/state.py`).

``TrainState`` holds what the JAX package's state pytree holds, in torch
objects: the module (float32 master parameters and BatchNorm buffers),
the optimizer, the LR scheduler, the step count, and the
``torch.Generator`` that dropout draws from.

``eval_step`` is the JAX package's eval step (``make_eval_step``): the
forward in eval mode, in the weights' dtype (float32 in the Runner), with
an optional device decode of the outputs.

``make_train_step`` follows the JAX step's semantics, whatever keys the
net's output dict holds (the loss function reads them):

- **Mixed precision as flax computes it**: with a ``compute_dtype`` the
  float32 master parameters are cast inside the differentiated function
  (``torch.func.functional_call`` on the cast parameters), so gradients
  come back float32 and every layer runs in the dtype flax would run it
  in: bf16 on the image path, whose input is cast to bf16; float32 on
  bf16-ROUNDED weights on the LiDAR path, whose points stay float32 and
  make flax promote (the JAX LiDAR train step's quirk, as for serving in
  `models/nets.py::round_weights_as_flax_promotes`).  The losses run in
  float32.
- **NaN guard** (`runner.py:178` of the reference): a non-finite loss
  leaves parameters, BatchNorm buffers (written during the forward, so
  restored), optimizer state and LR schedule as they were, and still
  advances ``step``; ``skipped_nan`` reports it, a Python float of this
  step.  The guard reads the loss, not the gradients, with one host read a
  step.  On the card at a world of one the loss's finiteness is copied to
  a pinned host flag, and an event recorded, before the backward pass is
  enqueued; the read after it waits on that event, so only for the
  forward pass and the loss, which the card has long finished, and not
  for the backward pass.  On the CPU, and across ranks (whose global loss
  exists only after an all-reduce that follows the backward pass), the
  read takes the loss where the guard stands.
- **Spans and counters** (`utils/logger.py`, recorded only while a
  profiler runs): the step ``train.step`` holds its host phases
  ``train.buffers``, ``train.cast``, ``train.forward``, ``train.loss``
  (with the guard's flag copy), ``train.backward``, ``train.guard`` (the
  read) and ``train.optimizer``, in that order; a device idle gap that
  straddles two phases falls in ``train.step``.  The counter
  ``guard_waits`` adds the reads that found the card not yet done: 0 or 1
  a step.
- **Data parallel as the JAX step under pjit** (a process group of more
  than one rank, `parallel/dist.py`): each rank runs the backward pass on
  its contribution to the global loss (`models/head_losses.py`; BatchNorm
  normalises over the global batch, `models/norm.py`), one ``all_reduce``
  of the stacked loss terms makes the logged terms and ``loss`` the global
  ones, the NaN guard decides on that global loss (so every rank skips
  together), one ``all_reduce`` (SUM) of the float32 master gradients as a
  single flat buffer gives every rank the global gradient, and the
  optimizer steps on it.  The model is not wrapped in
  ``DistributedDataParallel``: the step differentiates through
  ``functional_call`` on cast parameters, which bypasses its forward and so
  its gradient hooks.  At a world of one no collective runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..parallel.dist import get_world_size, sum_over_ranks
from ..utils.logger import count, recording, trace_span, traced


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator
    step: int = 0


def create_train_state(model: torch.nn.Module, cfg) -> TrainState:
    """Optimizer, scheduler and dropout generator (seeded from
    ``cfg.seed``) around ``model``, on the model's device."""
    from ..models.norm import set_dropout_generator
    from .optimizer import build_optimizer

    device = next(model.parameters()).device
    opt, sched = build_optimizer(cfg, model.parameters())
    gen = torch.Generator(device=device).manual_seed(cfg.get("seed", 0))
    set_dropout_generator(model, gen)
    return TrainState(model=model, optimizer=opt, scheduler=sched,
                      generator=gen)


def is_mono_batch(a) -> bool:
    """Whether an image batch is channel-replicated mono ([B,H,W,3] with all
    three channels identical).  BEV intensity tiles are one LiDAR return
    intensity replicated into 3 PNG channels (reference
    `laserlane_proposals.py:85-98` loads them unchanged); such a batch can
    ship as ONE channel and be broadcast back on the device — 3x less
    upload, bit-identical activations."""
    return bool(a.ndim == 4 and a.shape[-1] == 3
                and np.array_equal(a[..., 0], a[..., 1])
                and np.array_equal(a[..., 1], a[..., 2]))


def model_input(batch: Dict, use_lidar: bool = False,
                compute_dtype: Optional[torch.dtype] = None):
    """The net's forward input from a device batch: the NHWC image tile,
    or on the raw-LiDAR path the padded points and their mask.  A uint8
    ``proj`` (the PNG sources are uint8, so /255 on the device is
    bit-identical to the host float path) is divided by 255 in float32 and
    cast to ``compute_dtype``; a mono tile shipped as one channel is
    broadcast back to three."""
    if use_lidar:
        return {"points": batch["points"], "points_mask": batch["points_mask"]}
    proj = batch["proj"]
    if proj.dtype == torch.uint8:
        proj = proj.float() / 255.0
        if compute_dtype is not None:
            proj = proj.to(compute_dtype)
    if proj.shape[-1] == 1:
        proj = proj.expand(*proj.shape[:-1], 3)
    return proj.contiguous()


def eval_step(model: torch.nn.Module, inp,
              decode: Optional[Callable[[Dict], Dict]] = None) -> Dict:
    """``model(inp)`` in eval mode without autograd, then ``decode`` of
    the output dict (if given), all on the model's device."""
    model.eval()
    with torch.inference_mode():
        out = model(inp)
        return decode(out) if decode is not None else out


def make_train_step(loss_fn: Callable[[Dict, Dict], Dict],
                    compute_dtype: Optional[torch.dtype] = None,
                    use_lidar: bool = False
                    ) -> Callable[[TrainState, Dict], Dict]:
    """``step(state, batch) -> stats``: one update of ``state`` in place.
    ``loss_fn(out, batch) -> {'loss', 'loss_stats'}``; ``stats`` holds the
    loss terms (0-dim tensors on the device), ``loss`` and
    ``skipped_nan``."""
    # flax promotes bf16 weights against the float32 points
    act_dtype = torch.float32 if use_lidar else compute_dtype

    def cast(p: torch.Tensor) -> torch.Tensor:
        if p.dtype != torch.float32:
            return p
        q = p.to(compute_dtype)
        return q.to(act_dtype) if act_dtype != compute_dtype else q

    flag = done = None  # the guard's pinned host flag and its event

    @traced("train.step")
    def step(state: TrainState, batch: Dict) -> Dict:
        nonlocal flag, done
        model = state.model
        model.train()
        with trace_span("train.buffers"):
            buffers = [b.detach().clone() for b in model.buffers()]
        with trace_span("train.cast"):
            inp = model_input(batch, use_lidar, compute_dtype)
            if compute_dtype is not None:
                params = {n: cast(p) for n, p in model.named_parameters()}
        with trace_span("train.forward"):
            if compute_dtype is None:
                out = model(inp)
            else:
                out = torch.func.functional_call(model, params, (inp,))
        world = get_world_size()
        with trace_span("train.loss"):
            res = loss_fn(out, batch)
            loss = res["loss"]
            early = loss.is_cuda and world == 1
            if early:
                if flag is None:
                    flag = torch.empty((), dtype=torch.bool, pin_memory=True)
                    done = torch.cuda.Event()
                flag.copy_(torch.isfinite(loss), non_blocking=True)
                done.record(torch.cuda.current_stream(loss.device))
        with trace_span("train.backward"):
            state.optimizer.zero_grad(set_to_none=False)
            loss.backward()
        stats = {k: v.detach() for k, v in res["loss_stats"].items()}
        stats["loss"] = loss.detach()
        if world > 1:
            # the global loss and terms: the sums of the contributions
            keys = list(stats)
            stats = dict(zip(keys, sum_over_ranks(torch.stack(
                [stats[k].float() for k in keys])).unbind()))
        with trace_span("train.guard"):  # the step's one wait on the card
            if early:
                if recording():
                    count("guard_waits", not done.query())
                done.synchronize()
                ok = bool(flag)
            else:
                # a read of a loss on the card waits for all it has queued
                count("guard_waits", stats["loss"].is_cuda)
                ok = bool(torch.isfinite(stats["loss"]))
        if ok:
            with trace_span("train.optimizer"):
                for p in model.parameters():
                    # optax updates every leaf: a parameter the loss does not
                    # reach takes a zero gradient (AdamW still decays it)
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                if world > 1:
                    grads = [p.grad for p in model.parameters()]
                    flat = sum_over_ranks(torch.cat([g.reshape(-1)
                                                     for g in grads]))
                    for g, s in zip(grads, flat.split([g.numel()
                                                       for g in grads])):
                        g.copy_(s.view_as(g))
                state.optimizer.step()
                state.scheduler.step()
        else:
            with torch.no_grad():
                for b, saved in zip(model.buffers(), buffers):
                    b.copy_(saved)
        state.step += 1
        stats["skipped_nan"] = 0.0 if ok else 1.0
        return stats

    return step
