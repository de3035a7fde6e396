"""Training from a resident ring of batches, as a survey team trains or
fine-tunes on its own tiles, for ``--seconds``.

Set-up builds one train state (the program's model at the seed's weights,
its Adam and schedule, `engine/state.py::create_train_state`), the step
`Runner.train` runs (`engine/state.py::make_train_step` with the
column-proposal loss at the configuration's training dtype) and a ring of
distinct seeded batches on the card.  It then takes the first three steps
through the window's own call on ring batches 0, 1, 2 (the first one
builds K1z and picks the convolution algorithms): those are the steps the
reference follows, and the first one's head outputs are kept on the host
for the check.  The window keeps stepping the same state round the
ring; each step reads its loss on the host, as the program's step does
for its NaN guard.  A step counts when it ends inside the window, which
closes with a synchronise.
"""

from __future__ import annotations

import json
import tempfile
from typing import Dict

import torch

from lanebench import core, inputs, reference
from lanebench.weights import draw_state_dict


def program_state(cfg_d: Dict, seed: int, device):
    """(config, train state, step) of the program at the seed's weights."""
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.engine.state import (create_train_state,
                                                    make_train_step)
    from lanemapping_tpu_torch.models.head_losses import (
        column_proposal_loss, head_hparams)
    from lanemapping_tpu_torch.models.nets import build_model
    from lanebench.plain import build_model as plain_build

    cfg = Config(json.loads(json.dumps(cfg_d)))
    model = build_model(cfg).to(device)
    model.load_state_dict(draw_state_dict(plain_build(cfg_d), seed, device))
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    state = create_train_state(model, cfg)
    hp = head_hparams(cfg)
    dtype = torch.bfloat16 if cfg.get("train_compute_dtype") == "bfloat16" \
        else None
    step = make_train_step(lambda out, b: column_proposal_loss(out, b, hp),
                           dtype, bool(cfg.get("use_lidar", False)))
    return cfg, state, step


def ring(cfg_d: Dict, tr: Dict, seed: int, device):
    """The traffic mix's ring of distinct batches on the device."""
    n, B = int(tr["ring"]), int(tr["batch"])
    clouds = None
    if cfg_d.get("use_lidar", False):
        clouds = inputs.survey_clouds(n * B, int(tr["points"]),
                                      cfg_d["list_img_size_xy"][0], seed,
                                      device)
    return inputs.train_batches(cfg_d, n, B, seed, device, clouds)


def _next_outputs(model) -> Dict[str, torch.Tensor]:
    """The model's head outputs of its next forward, kept on the host in
    float32 (a forward hook that removes itself once it has fired)."""
    kept: Dict[str, torch.Tensor] = {}

    def hook(module, args, out):
        kept.update({k: v.detach().float().cpu() for k, v in out.items()})
        handle.remove()
    handle = model.register_forward_hook(hook)
    return kept


def _exp_avg_norms(state) -> Dict[str, float]:
    """The first gradient as Adam got it, from its state after one step
    (torch's Adam keeps (1 - b1) * g as the first moment; a leaf it
    holds no state for reads 0)."""
    b1 = state.optimizer.param_groups[0]["betas"][0]
    opt = state.optimizer.state
    return {n: float(torch.linalg.vector_norm(
        opt[p]["exp_avg"].double() / (1.0 - b1))) if p in opt else 0.0
        for n, p in state.model.named_parameters()}


def run(cell, rec: core.Run, seed: int, seconds: float, device,
        t_start: float) -> None:
    from lanemapping_tpu_torch.kernels.voxel_bin import voxel_bin_mean

    tr = cell.traffic
    cfg_d = dict(cell.config)
    B = int(tr["batch"])
    cuda = device.type == "cuda"
    cfg, state, step = program_state(cfg_d, seed, device)
    batches = ring(cfg_d, tr, seed, device)
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    launched = voxel_bin_mean.launches
    losses = []
    out1 = _next_outputs(state.model)
    for i in range(3):
        losses.append(float(step(state, batches[i])["loss"]))
        if i == 0:
            grad1 = _exp_avg_norms(state)
    change = reference.leaf_norms(
        {n: p.detach() - start[n] for n, p in state.model.named_parameters()})
    del start
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rec.notes["setup_s"] = core.now() - t_start

    # -- the window ---------------------------------------------------------
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
    # the rate over each third of the window, by the host's clock (the
    # program's step reads its loss, so a step has ended on the device)
    thirds = [t0 + k * window / 3 for k in range(4)]
    rec.notes["tiles_per_s_by_third"] = [
        B * sum(a < e <= b for e in ends) / (b - a)
        for a, b in zip(thirds, thirds[1:])]
    rec.launches = {"voxel_bin_mean": voxel_bin_mean.launches - launched}
    from lanebench import flops
    if cfg_d.get("use_lidar", False):
        rec.kernel_bytes = {"k1z": flops.k1z_bytes(
            B, int(tr["points"]), 4, cfg_d["grid_size"])}
    if rec.tracing:  # the FLOPs of a step
        rec.unit_flops = flops.model_flops(cfg_d, B, True, int(tr["points"]))
    del state, step, batches
    if cuda:
        torch.cuda.empty_cache()

    # -- the check: the reference follows the first three steps -------------
    t = core.now()
    check(cell, rec, seed, device, losses, out1, grad1, change, "float32")
    rec.notes["check_s"] = core.now() - t


def reference_steps(cell, seed: int, device, level: str) -> Dict:
    cfg_d = dict(cell.config)
    batches = ring(cfg_d, cell.traffic, seed, device)[:3]
    sd = draw_state_dict(_plain(cfg_d), seed, device)
    out = reference.train_steps(cfg_d, sd, batches, level)
    del batches, sd
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def readings(losses, out1, grad1, change, ref, worst=None
             ) -> Dict[str, float]:
    """The numbers of a run against the reference's: the first step's loss
    and the worst of the three (relative); the first step's head outputs
    over the batch (`reference.batch_head_gap`); the first gradient's and
    the three steps' change's norms by leaf, the worst leaf's gap and the
    median leaf's (`reference.norm_gap`; the leaves whose reference
    gradient is round-off left out).  ``worst`` collects the leaf that
    sets each worst gap."""
    keep = reference.moved_leaves(ref["grad1"])
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(losses, ref["losses"])]
    return {
        "loss1_gap": gaps[0],
        "loss_gap": max(gaps),
        "head1_gap": reference.batch_head_gap(out1, ref["out1"]),
        "grad_gap": reference.norm_gap(grad1, ref["grad1"], keep, worst,
                                       "grad"),
        "grad_gap_median": reference.norm_gap(grad1, ref["grad1"], keep,
                                              q=0.5),
        "change_gap": reference.norm_gap(change, ref["change"], keep, worst,
                                         "change"),
        "change_gap_median": reference.norm_gap(change, ref["change"], keep,
                                                q=0.5),
    }


def check(cell, rec, seed, device, losses, out1, grad1, change, level
          ) -> None:
    """The numbers the cell's limits name are checked; the others are
    kept in the notes."""
    ref = reference_steps(cell, seed, device, level)
    rec.notes["losses"] = losses
    rec.notes["ref_losses"] = ref["losses"]
    worst = {}
    for k, v in readings(losses, out1, grad1, change, ref, worst).items():
        if k in cell.limits:
            rec.check(k, v, cell.limits[k])
        else:
            rec.notes.setdefault("readings", {})[k] = v
    rec.notes["worst_leaf"] = worst


def _plain(cfg_d):
    from lanebench.plain import build_model
    return build_model(cfg_d)
