"""Loss curves of the JAX Runner and the port's Runner trained side by
side on the CPU from the same seeded weights and the same data order, at
a tiny config, for some tens of steps: where a soak on the card lands
away from the JAX package's record, this tells a fault of the port's
training from a difference of protocol.

    JAX_PLATFORMS=cpu python tests/torch_port_loss_curves.py \\
        --config configs/tiny_test_lidar.py --steps 48 --out curves.json

Both Runners train ``Runner.train`` at the config's optimizer with a
cosine schedule over the run, log every step and validate once at the
end, on a ``generate_dataset(img=192)`` set of ``--tiles`` tiles (with
4096-point clouds for a LiDAR config).  Prints, per window of 8 steps,
each package's mean loss and their relative difference, and writes every
step's loss terms and both validations to ``--out``.  At random weights
the two float32 runs part in their low bits within a few steps (see
`test_torch_port_dist_jax.py`), so the curves are compared by window,
not step by step.
"""

import argparse
import json
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch_port_helpers import (configs, lidar_example,  # noqa: E402
                                random_variables, seeded_jax_runners,
                                wire_data_root)


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--tiles", type=int, default=40)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--set", action="append", default=[],
                    help="config overrides key=value for both packages")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import lanemapping_tpu as lm
    from lanemapping_tpu.config.config import parse_dict_action
    from lanemapping_tpu.engine.runner import Runner as JaxRunner
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.tools.from_jax import load_jax_weights

    tmp = tempfile.mkdtemp(prefix="loss_curves_")
    root = os.path.join(tmp, "data")
    cfg_j, cfg_t = configs(args.config)
    lidar = bool(cfg_j.get("use_lidar", False))
    generate_dataset(root, n_tiles=args.tiles, img=192, seed=5,
                     with_points=lidar, points_per_tile=4096)
    n_train = int(0.6 * args.tiles)
    per_epoch = n_train // args.batch
    epochs = -(-args.steps // per_epoch)
    over = {"batch_size": args.batch, "epochs": epochs, "eval_ep": epochs,
            "save_ep": 10 ** 6, "log_every": 1, "gt_cache": False,
            "total_iter": per_epoch * epochs,
            "scheduler": dict(type="CosineAnnealingLR",
                              T_max=per_epoch * epochs),
            **parse_dict_action(args.set)}
    for cfg in (cfg_j, cfg_t):
        wire_data_root(cfg, root)
        cfg.merge_from_dict(over)
    example = lidar_example(cfg_j.max_points) if lidar \
        else jnp.zeros((1, 192, 192, 3))
    variables = random_variables(lm.build_model(cfg_j), (example,),
                                 args.seed)

    with seeded_jax_runners(variables):
        jrun = JaxRunner(cfg_j, log_dir=os.path.join(tmp, "jax"))
    jrun._tb = None
    jrun.train(max_iters=args.steps)
    jmetrics = jrun.validate()
    trun = Runner(cfg_t, log_dir=os.path.join(tmp, "port"), device="cpu")
    trun._tb = None
    load_jax_weights(trun.model, variables["params"],
                     variables["batch_stats"], cfg_t)
    trun.train(max_iters=args.steps)
    tmetrics = trun.validate()

    jlog = read_jsonl(os.path.join(tmp, "jax", "train.jsonl"))
    tlog = read_jsonl(os.path.join(tmp, "port", "train.jsonl"))
    assert [r["iter"] for r in jlog] == [r["iter"] for r in tlog]
    jl = np.array([r["loss"] for r in jlog])
    tl = np.array([r["loss"] for r in tlog])
    windows = []
    for a in range(0, len(jl), 8):
        mj, mt = float(jl[a:a + 8].mean()), float(tl[a:a + 8].mean())
        windows.append({"steps": [a, min(a + 8, len(jl)) - 1],
                        "jax": mj, "port": mt, "rel": (mt - mj) / mj})
        print(f"steps {a:3d}-{min(a + 8, len(jl)) - 1:3d}: loss JAX {mj:.6f}"
              f" port {mt:.6f} rel {(mt - mj) / mj:+.4e}", flush=True)
    print("validate JAX", {k: round(float(v), 4) for k, v in jmetrics.items()})
    print("validate port", {k: round(float(v), 4)
                            for k, v in tmetrics.items()})
    rec = {"config": os.path.relpath(args.config, os.path.dirname(HERE)),
           "steps": len(jl), "batch": args.batch, "tiles": args.tiles,
           "seed": args.seed, "overrides": args.set, "windows": windows,
           "jax": jlog, "port": tlog,
           "validate": {"jax": {k: float(v) for k, v in jmetrics.items()},
                        "port": {k: float(v) for k, v in tmetrics.items()}}}
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()
