"""The readings that the KLane RowRef cell's limits are set from
(`lanebench/limits/rowref.train.json`), on the card at the cell's own size,
many seeds in one process: `lanebench/control.py` for the loop
``train_rows``, whose reference follows a route.

    python3 lanebench/control_rows.py --workload rowref.train \\
        --seeds 1,2,3 [--seconds 12] [--program 1] [--control 1] \\
        [--faults 1]

For each seed it prints one JSON line:

- ``program``: a run of the cell (a short window), judged against the
  float32 reference on the program's route as every run is
  (``program_correct``, expected true), with ``program_route``: the
  decisions the reference would have taken otherwise at all, and their
  largest probability gaps, which set the margins;
- ``control``: the reference one step below the configuration's
  precision (float8 e4m3 operands under bf16, `lanebench/precision.py`,
  the lane-batched products included) on its own route, in the program's
  place: judged against the float32 reference on the control's route
  (``control_correct``, expected false), with ``control_route``;
- with ``--faults 1``, the program with half of each batch left out
  (``half_batch_correct``, expected false).

The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lanebench import control as base, core  # noqa: E402


def control_readings(cell, seed, device, level):
    drv = core.loop(cell)
    low = drv.reference_steps(cell, seed, device, level)
    ref = drv.reference_steps(cell, seed, device, "float32", low["routes"])
    worst = {}
    out = drv.readings(low["losses"], low["out1"], low["grad1"],
                       low["change"], ref, worst)
    return out, ref["route"], worst


def seed_line(cell, seed, device, level, seconds, program=True,
              control=True, faults=False) -> dict:
    """The readings of one seed, each judged."""
    line = {"seed": seed, "control_level": level}
    if program:
        line["program"], rec = base.program_readings(cell, seed, seconds,
                                                     device)
        line["program_correct"] = rec.correct
        line["program_route"] = rec.notes["route"]
        line["program_e2e"] = rec.e2e
        line["program_notes"] = {k: rec.notes[k] for k in
                                 ("worst_leaf", "check_s", "setup_s",
                                  "losses", "ref_losses")}
    if control:
        line["control"], line["control_route"], line["control_worst"] = \
            control_readings(cell, seed, device, level)
        line["control_correct"], line["control_checks"] = base.judged(
            line["control"], cell.limits)
    if faults:
        line["half_batch"], rec = base.program_readings(
            cell, seed, 1.0, device, step_wrap=base.half_batch)
        line["half_batch_correct"] = rec.correct
        line["half_batch_route"] = rec.notes["route"]
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
    level = base.LOWER[cell.config["train_compute_dtype"]]
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
