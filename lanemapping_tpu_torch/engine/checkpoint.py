"""Checkpoint save/load (port of `lanemapping_tpu/engine/checkpoint.py`).

``save_model`` writes ``<log_dir>/ckpt/<tag>/state.pt`` with
``torch.save``: the model's ``state_dict``, the optimizer's and the
scheduler's, the step, and the dropout generator's state with its device
type.  ``load_model`` restores all of it (a full resume, as the JAX package
does; the reference restores weights only).  A generator's state only fits
a generator of its own device type (a CUDA state is 16 bytes, a CPU state
5056), so a resume on another device type reseeds the generator from
``(seed, step)`` instead and logs it; the JAX package's checkpoints hold a
plain PRNG key and have no such limit.  An evaluation load reads the
weights alone (`api.py::load_checkpoint`).  ``load_network_filtered`` is the
finetune load: it
keeps the entries whose shapes match the model (reference
`net_utils.py:23-33`), from such a checkpoint or from a plain torch
``state_dict`` / reference ``.pth``.  Orbax checkpoints of the JAX package
would need JAX; their weights cross through `tools/from_jax.py`.

In a process group of more than one rank, rank 0 writes (every rank holds
the same state) and all ranks then meet at a barrier, so none reads a
checkpoint before it is complete; every rank loads.
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import torch

from ..parallel.dist import is_main_process, synchronize
from .state import TrainState

STATE_FILE = "state.pt"
log = logging.getLogger(__name__)


def _ckpt_dir(log_dir: str) -> str:
    d = os.path.join(os.path.abspath(log_dir), "ckpt")
    os.makedirs(d, exist_ok=True)
    return d


def save_model(log_dir: str, state: TrainState, tag: str) -> str:
    path = os.path.join(_ckpt_dir(log_dir), tag)
    if is_main_process():
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "scheduler": state.scheduler.state_dict(),
                    "step": state.step,
                    "generator": state.generator.get_state(),
                    "generator_device": state.generator.device.type}, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
    synchronize()
    return path


def _read(path: str) -> Dict:
    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model(path: str, state: TrainState, seed: int = 0) -> TrainState:
    """Restore a ``save_model`` checkpoint (its directory) into ``state``,
    in place.  The generator's state is restored on the device type it was
    saved on (bit-identical resume); on another device type the generator
    is seeded with ``seed * 2^32 + step`` instead."""
    ckpt = _read(path)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = int(ckpt["step"])
    own = state.generator.device.type
    saved = ckpt.get("generator_device")
    if saved is None:  # written before the device type was recorded
        same = ckpt["generator"].numel() == state.generator.get_state().numel()
    else:
        same = saved == own
    if same:
        state.generator.set_state(ckpt["generator"])
    else:
        state.generator.manual_seed(int(seed) * 2 ** 32 + state.step)
        log.warning("%s: the dropout generator was saved on %s; resuming on "
                    "%s, it is reseeded from (seed %d, step %d)", path,
                    saved or "another device type", own, seed, state.step)
    return state


def load_network_filtered(path: str, state: TrainState) -> TrainState:
    """Finetune load into ``state.model``: the weights of a checkpoint
    directory, a ``state.pt`` or a torch ``state_dict`` file (``net`` /
    ``state_dict`` / ``model`` containers and ``module.`` prefixes
    accepted) whose shapes match; the rest keep their values.  A 7x7 stem
    goes into an ``s2d_stem`` model through the exact kernel transform."""
    from ..models.resnet_fpn import load_s2d_stem

    ckpt = _read(path)
    for key in ("model", "net", "state_dict"):
        if isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
            break
    own = state.model.state_dict()
    sd = load_s2d_stem({k[len("module."):] if k.startswith("module.") else k:
                        v for k, v in ckpt.items()}, own)
    keep = {k: v for k, v in sd.items()
            if k in own and tuple(own[k].shape) == tuple(v.shape)}
    state.model.load_state_dict(keep, strict=False)
    return state
