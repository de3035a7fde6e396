"""The trained-checkpoint recipe: generate the synthetic sets, soak both
main configs and run the checkpoint tools on the result, on the card.

    python -m lanemapping_tpu_torch.tools.soak_recipe flagship \\
        --work <dir> --out <dir> [--seeds 2021 7] [--n-tiles 1024]
    python -m lanemapping_tpu_torch.tools.soak_recipe lidar \\
        --work <dir> --out <dir> [--n-tiles 256]

``flagship``: ``generate_dataset(n_tiles=1024, img=1152, seed=0,
with_params=True)``, the set of the JAX package's soaks (train 614 tiles,
valid 205); per seed, `tools/soak_run.py` stages train, endp, refkit and
stream at lr 2.1e-4 (the config's), batch 8, bf16, 16 epochs = 1216
steps, validation every 2 epochs; then, on the first seed's best
checkpoint, `tools/endp_sweep.py`, `tools/validate_ab.py` and
`tools/stream_bench.py` with a ``--from-las`` run on ``--las-tiles``
clouds of the test split (`data/synthetic.py::add_structured_las`, 2^19
points each).  The second seed's soak runs last.

``lidar``: ``generate_dataset(n_tiles=256, img=1152, seed=7,
with_points=True, points_per_tile=2^17)``; the LiDAR config's soak stages
train, refkit_lidar and lidar at batch 4, 24 epochs = 912 steps, with
``max_points=2^17``.

The sets and checkpoints go under ``--work``, every record (and a log of
the steps with their wall seconds) under ``--out``.  ``--n-tiles``,
``--epochs`` and ``--runs`` shrink the recipe for a rehearsal; ``--set``
passes config overrides to every soak (after the recipe's own).
"""

from __future__ import annotations

import argparse
import json
import os
import time

from .soak_run import LIDAR_CFG

T0 = time.time()


def log(out_dir, msg):
    line = f"[soak_recipe {time.time() - T0:9.1f} s] {msg}"
    print(line, flush=True)
    with open(os.path.join(out_dir, "recipe.log"), "a") as f:
        f.write(line + "\n")


def generate(out_dir, root, **kw):
    from ..data.synthetic import generate_dataset
    if os.path.isfile(os.path.join(root, "data_split-shuffle.json")):
        return
    t0 = time.time()
    generate_dataset(root, img=1152, **kw)
    log(out_dir, f"generated {kw} under {root} in {time.time() - t0:.3f} s")


def las_root_of(out_dir, root, las_root, n_clouds):
    """A root of ``n_clouds`` 2^19-point clouds of ``root``'s test split
    (``las/``), with ``root``'s labels, for the ``--from-las`` run."""
    from ..data.synthetic import add_structured_las
    os.makedirs(las_root, exist_ok=True)
    if not os.path.exists(os.path.join(las_root, "labels")):
        os.symlink(os.path.abspath(os.path.join(root, "labels")),
                   os.path.join(las_root, "labels"))
    with open(os.path.join(root, "data_split-shuffle.json")) as f:
        stems = json.load(f)["test"][:n_clouds]
    t0 = time.time()
    add_structured_las(las_root, stems=stems)
    log(out_dir, f"wrote {len(stems)} clouds under {las_root} in "
        f"{time.time() - t0:.3f} s")


def sets(args):
    return [a for kv in args.set for a in ("--set", kv)]


def flagship(args):
    from . import soak_run
    root = os.path.join(args.work, "synth_flagship")
    generate(args.out, root, n_tiles=args.n_tiles or 1024, seed=0,
             with_params=True)
    for i, seed in enumerate(args.seeds):
        t0 = time.time()
        soak_run.main(["--data-root", root, "--stages",
                       "train,endp,refkit,stream", "--epochs",
                       str(args.epochs or 16), "--set", f"seed={seed}",
                       "--log-dir", os.path.join(args.work,
                                                 f"soak_seed{seed}"),
                       "--out", os.path.join(args.out,
                                             f"soak_seed{seed}.json"),
                       *sets(args)])
        log(args.out, f"soak seed {seed} done in {time.time() - t0:.3f} s")
        if i == 0:
            checkpoint_tools(args, root, os.path.join(
                args.work, f"soak_seed{seed}", "ckpt", "best"))


def checkpoint_tools(args, root, best):
    """endp_sweep, validate_ab and stream_bench (with its ``--from-las``
    run) on the checkpoint ``best``."""
    from . import endp_sweep, stream_bench, validate_ab
    las_root = os.path.join(args.work, "synth_flagship_las")
    las_root_of(args.out, root, las_root, args.las_tiles)
    for name, tool, extra in (
            ("endp_sweep", endp_sweep, []),
            ("validate_ab", validate_ab, []),
            ("stream_bench", stream_bench,
             ["--runs", str(args.runs), "--from-las", "--las-root",
              las_root])):
        t0 = time.time()
        tool.main(["--data-root", root, "--ckpt", best, "--log-dir",
                   os.path.join(args.work, name), "--out",
                   os.path.join(args.out, f"{name}.json"), *extra])
        log(args.out, f"{name} done in {time.time() - t0:.3f} s")


def lidar(args):
    from . import soak_run
    root = os.path.join(args.work, "synth_lidar")
    points = 1 << 17
    generate(args.out, root, n_tiles=args.n_tiles or 256, seed=7,
             with_points=True, points_per_tile=points)
    t0 = time.time()
    soak_run.main(["--config", LIDAR_CFG, "--data-root", root,
                   "--lidar-root", root, "--stages",
                   "train,refkit_lidar,lidar", "--epochs",
                   str(args.epochs or 24), "--batch", "4", "--lidar-points",
                   str(points), "--set", f"max_points={points}", "--log-dir",
                   os.path.join(args.work, "soak_lidar"), "--out",
                   os.path.join(args.out, "soak_lidar.json"), *sets(args)])
    log(args.out, f"LiDAR soak done in {time.time() - t0:.3f} s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", choices=("flagship", "lidar"))
    ap.add_argument("--work", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[2021, 7])
    ap.add_argument("--n-tiles", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--las-tiles", type=int, default=64)
    ap.add_argument("--set", action="append", default=[],
                    help="config overrides key=value for every soak")
    args = ap.parse_args(argv)
    os.makedirs(args.work, exist_ok=True)
    os.makedirs(args.out, exist_ok=True)
    {"flagship": flagship, "lidar": lidar}[args.which](args)
    log(args.out, f"{args.which} recipe done")


if __name__ == "__main__":
    main()
