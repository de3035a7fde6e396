"""KLane RowRef training from a resident ring of batches, for
``--seconds``: the row-wise head with lane-token refinement on the
flagship's encoder and correlator, as a survey team trains the KLane
baseline on its own tiles.

Set-up builds the program's net at the seed's weights
(`models/nets.py::build_model`, weights by `lanebench/rows.py`), its train
state (`engine/state.py::create_train_state`) and the step `Runner.train`
runs: `engine/state.py::make_train_step` at the configuration's training
dtype with the loss of `engine/runner.py::Runner._build_loss` for the
configuration's head (``row_shar_loss``).  The ring holds distinct seeded
batches of uniform tiles and LaserLane row labels
(`lanebench/rows.py::train_batches`).  The first three steps run through
the window's own call on ring batches 0, 1, 2; for each, a forward hook
keeps the head's discrete decisions (``argmax`` of the returned ``cls``,
the gate of the returned ``ext``, computed on the card from the tensors
the head used), and the first one's outputs.  The window, the traced
stretch and the third-by-third rate are `loops/train.py`'s.

The check: the float32 reference (`lanebench/reference_rows.py`) takes
the same three steps on the program's decisions, and is held to the
program's losses, first outputs, first gradient and change by leaf
(`loops/train.py::readings`); ``route_flips`` counts the decisions the
reference would have taken otherwise beyond the rounding margins of the
cell's limits (``_route_margin``, ``_gate_margin``).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List

import torch

from lanebench import core, reference, reference_rows, rows

_train = core.load_file_module(os.path.join(core.HERE, "loops", "train.py"),
                               "lanebench_loop_train")


def program_state(cfg_d: Dict, seed: int, device):
    """(config, train state, step) of the program at the seed's weights."""
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.engine.state import (create_train_state,
                                                    make_train_step)
    from lanemapping_tpu_torch.models.nets import build_model

    cfg = Config(json.loads(json.dumps(cfg_d)))
    model = build_model(cfg).to(device)
    model.load_state_dict(rows.draw_state_dict(cfg_d, seed, device))
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    state = create_train_state(model, cfg)
    dtype = torch.bfloat16 if cfg.get("train_compute_dtype") == "bfloat16" \
        else None
    step = make_train_step(Runner._build_loss(cfg, cfg.heads.type), dtype,
                           False)
    return cfg, state, step


def ring(cfg_d: Dict, tr: Dict, seed: int, device):
    return rows.train_batches(cfg_d, int(tr["ring"]), int(tr["batch"]),
                              seed, device)


def _decisions(model, thr: float, n: int, out1: Dict) -> List[tuple]:
    """The head's decisions of the model's next ``n`` forwards, as
    (window starts [B,N,S], gates [B,N]) on the host, and the first
    forward's outputs in ``out1`` (float32, on the host): a forward hook
    that removes itself after the ``n``-th."""
    taken: List[tuple] = []

    def hook(module, args, out):
        with torch.no_grad():
            taken.append((torch.argmax(out["cls"], dim=-1).cpu(),
                          (out["ext"][..., 0].mean(-1) > thr).cpu()))
            if len(taken) == 1:
                out1.update({k: v.detach().float().cpu()
                             for k, v in out.items()})
        if len(taken) == n:
            handle.remove()
    handle = model.register_forward_hook(hook)
    return taken


def run(cell, rec: core.Run, seed: int, seconds: float, device,
        t_start: float) -> None:
    tr = cell.traffic
    cfg_d = dict(cell.config)
    B = int(tr["batch"])
    cuda = device.type == "cuda"
    cfg, state, step = program_state(cfg_d, seed, device)
    batches = ring(cfg_d, tr, seed, device)
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    losses = []
    out1: Dict[str, torch.Tensor] = {}
    routes = _decisions(state.model, cfg_d["heads"]["thr_ext"], 3, out1)
    for i in range(3):
        losses.append(float(step(state, batches[i])["loss"]))
        if i == 0:
            grad1 = _train._exp_avg_norms(state)
    change = reference.leaf_norms(
        {n: p.detach() - start[n] for n, p in state.model.named_parameters()})
    del start
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rec.notes["setup_s"] = core.now() - t_start

    # -- the window (as loops/train.py) --------------------------------------
    n_ring = len(batches)
    i = 3
    steps = 0
    failed = 0
    ends = []
    t0 = core.now()
    deadline = t0 + seconds
    while core.now() < deadline:
        st = step(state, batches[i % n_ring])
        failed += int(st["skipped_nan"])
        i += 1
        steps += 1
        ends.append(core.now())
    if cuda:
        torch.cuda.synchronize()
    window = core.now() - t0
    if cuda:
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
    prof = core.Profiler(rec.tracing, tempfile.gettempdir())
    if rec.tracing:
        prof.start()
        for _ in range(int(tr["trace_steps"])):
            with prof.span("lanebench.train_step"):
                step(state, batches[i % n_ring])
            i += 1
        prof.stop()
    rec.trace = prof.reduce()
    rec.attempted = steps
    rec.failed = failed
    rec.units = steps
    rec.window_s = window
    rec.e2e["train_tiles_per_s"] = B * steps / window
    thirds = [t0 + k * window / 3 for k in range(4)]
    rec.notes["tiles_per_s_by_third"] = [
        B * sum(a < e <= b for e in ends) / (b - a)
        for a, b in zip(thirds, thirds[1:])]
    if rec.tracing:  # the FLOPs of a step
        rec.unit_flops = rows.model_flops(cfg_d, B)
    del state, step, batches
    if cuda:
        torch.cuda.empty_cache()

    # -- the check: the reference follows the first three steps -------------
    t = core.now()
    check(cell, rec, seed, device, losses, out1, grad1, change, routes)
    rec.notes["check_s"] = core.now() - t


def margins(cell) -> tuple:
    return (float(cell.limits["_route_margin"]),
            float(cell.limits["_gate_margin"]))


def reference_steps(cell, seed: int, device, level: str, routes=None
                    ) -> Dict:
    """The reference's three steps at ``level`` on ring batches 0-2, on
    ``routes`` where given."""
    cfg_d = dict(cell.config)
    batches = ring(cfg_d, cell.traffic, seed, device)[:3]
    sd = rows.draw_state_dict(cfg_d, seed, device)
    out = reference_rows.train_steps(cfg_d, sd, batches, level, routes,
                                     margins(cell))
    del batches, sd
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def readings(losses, out1, grad1, change, ref, worst=None
             ) -> Dict[str, float]:
    """`loops/train.py::readings`, and ``route_flips`` (the decisions
    that differ at all and their largest gaps are in ``ref["route"]``)."""
    out = _train.readings(losses, out1, grad1, change, ref, worst)
    out["route_flips"] = float(ref["route"]["flips"])
    return out


def check(cell, rec, seed, device, losses, out1, grad1, change, routes
          ) -> None:
    ref = reference_steps(cell, seed, device, "float32", routes)
    rec.notes["losses"] = losses
    rec.notes["ref_losses"] = ref["losses"]
    rec.notes["route"] = ref["route"]
    worst = {}
    for k, v in readings(losses, out1, grad1, change, ref, worst).items():
        if k in cell.limits:
            rec.check(k, v, cell.limits[k])
        else:
            rec.notes.setdefault("readings", {})[k] = v
    rec.notes["worst_leaf"] = worst
