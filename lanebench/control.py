"""The readings that a cell's limits are set from (`lanebench/limits/`),
on the card at the cell's own size, many seeds in one process.

    python3 lanebench/control.py --workload <name> --seeds 1,2,3 \\
        [--seconds 12] [--program 1] [--control 1] [--faults 1]

For each seed it prints one JSON line of readings of the numbers the
cell's check compares, each judged against the cell's limits by the rule
of every run (`core.within`: each number finite and at most its limit):

- ``program``: a run of the cell (a short window at the cell's own load),
  judged against the float32 reference as every run is
  (``program_correct``, expected true);
- ``control``: the reference itself put in the program's place, computed
  one step below the configuration's precision (`lanebench/precision.py`:
  float8 e4m3 operands under a bf16 configuration, bf16 under float32),
  judged against the limits (``control_correct``, expected false);
- with ``--faults 1`` on a training cell, the program with half of each
  batch left out (the mean taken over the rest), judged by the run's own
  check (``half_batch_correct``, expected false).  A step that leaves the
  state unchanged reads 1 on ``change_gap`` by its definition and needs no
  run.

The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lanebench import core, reference  # noqa: E402

LOWER = {"bfloat16": "float8", "float32": "bfloat16"}


def program_readings(cell, seed, seconds, device, step_wrap=None):
    rec = core.Run(cell, seconds, False)
    rec.device_kind = "control"
    drv = core.loop(cell)
    if step_wrap is not None:
        orig = drv.program_state

        def wrapped(*a, **k):
            cfg, state, step = orig(*a, **k)
            return cfg, state, step_wrap(step)
        drv.program_state = wrapped
    drv.run(cell, rec, seed, seconds, device, core.now())
    return {**{n: v for n, v, _ in rec.checks},
            **rec.notes.get("readings", {})}, rec


def half_batch(step):
    """The fault: each step sees the first half of its batch only, and
    its loss is the mean over that half."""
    def stepped(state, batch):
        n = next(iter(batch.values())).shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()})
    return stepped


def judged(readings, limits):
    """(correct, {number: {value, limit}}) of readings against a cell's
    limits, by the rule of `core.Run.correct`."""
    checks = [(k, float(readings[k]), float(limits[k])) for k in limits
              if k in readings]
    return core.within(checks), {k: {"value": v, "limit": lim}
                                 for k, v, lim in checks}


def control_readings(cell, seed, device, level):
    drv = core.loop(cell)
    if cell.traffic["loop"] == "train":
        ref = drv.reference_steps(cell, seed, device, "float32")
        low = drv.reference_steps(cell, seed, device, level)
        worst = {}
        out = drv.readings(low["losses"], low["out1"], low["grad1"],
                           low["change"], ref, worst)
        out["worst_leaf"] = worst
        return out
    return serve_control(cell, seed, device, level, drv)


def serve_control(cell, seed, device, level, drv):
    """The sampled tiles of the seed's run through the reference at
    ``level`` against the float32 reference."""
    import tempfile

    import torch

    from lanebench import inputs
    from lanebench.weights import draw_state_dict
    tr = cell.traffic
    B, n = int(tr["batch"]), int(tr["clouds"])
    sample = drv.sample_tiles(seed, int(tr["sample_within_batches"]), B,
                              int(tr["sample_tiles"]))
    tiles = [(i * B + j) % n for i, rows in sample.items() for j in rows]
    img = cell.config["list_img_size_xy"][0]
    work = tempfile.mkdtemp(prefix="lanebench_control_")
    try:
        clouds = inputs.survey_clouds(n, int(tr["points"]), img, seed, device)
        stems = inputs.write_survey(work, clouds)
        del clouds
        pts, msk = drv.load_tiles(work, [stems[t] for t in tiles],
                                  int(tr["points"]), device)
    finally:
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    sd = draw_state_dict(drv._plain(cell.config), int(cell.config["seed"]),
                         device)
    ref = reference.serve_tiles(cell.config, sd, pts, msk, "float32")
    low = reference.serve_tiles(cell.config, sd, pts, msk, level)
    del sd
    torch.cuda.empty_cache()
    return {"input_gap": max(reference.input_gap(a["input"], b["input"])
                             for a, b in zip(low, ref)),
            "head_gap": max(reference.head_gap(a["out"], b["out"])
                            for a, b in zip(low, ref))}


def seed_line(cell, seed, device, level, seconds, program=True,
              control=True, faults=False) -> dict:
    """The readings of one seed, each judged."""
    line = {"seed": seed, "control_level": level}
    if program:
        line["program"], rec = program_readings(cell, seed, seconds, device)
        line["program_correct"] = rec.correct
        line["program_e2e"] = rec.e2e
        line["program_notes"] = {
            k: rec.notes[k] for k in ("worst_leaf", "check_s", "drain_s",
                                      "setup_s", "tiles_compared")
            if k in rec.notes}
    if control:
        line["control"] = control_readings(cell, seed, device, level)
        line["control_correct"], line["control_checks"] = judged(
            line["control"], cell.limits)
    if faults and cell.traffic["loop"] == "train":
        line["half_batch"], rec = program_readings(
            cell, seed, 1.0, device, step_wrap=half_batch)
        line["half_batch_correct"] = rec.correct
        line["half_batch_worst_leaf"] = rec.notes.get("worst_leaf")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--program", type=int, default=1)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--faults", type=int, default=0)
    args = ap.parse_args(argv)
    cell = core.Cell(args.workload)
    torch = core.require_cards(cell.chips)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    core.log(f"card: {core.card_line()}")
    dtype = cell.config.get("train_compute_dtype"
                            if cell.traffic["loop"] == "train"
                            else "compute_dtype")
    # the LiDAR configuration computes float32 (on bf16-rounded weights)
    stated = "float32" if cell.config.get("use_lidar") else dtype
    level = LOWER[stated]
    for s in (int(x) for x in args.seeds.split(",")):
        line = seed_line(cell, s, device, level, args.seconds,
                         args.program, args.control, args.faults)
        line["wall_s"] = core.now() - T_START
        for k in ("program_correct", "control_correct",
                  "half_batch_correct"):
            if k in line:
                core.log(f"seed {s}: {k} {line[k]}")
        print(json.dumps(line), flush=True)
    bad = core.forbidden_modules(list(sys.modules))
    if bad:
        core.log(f"JAX or the JAX package was loaded: {bad}")
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
