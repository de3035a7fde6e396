"""The port's checkpoint tools against the JAX root scripts
(`tools/endp_sweep.py`, `tools/validate_ab.py`, `tools/stream_bench.py`,
loaded with ``importlib`` from their paths) and the JAX package's
``export_lane_seqs`` and streaming chain, on the CPU at
``configs/tiny_test.py``.

Weights are numpy-seeded flax variables: the JAX tools read them from a
JAX checkpoint, the port's from a port checkpoint of the same weights
carried by `tools/from_jax.py`.  Metrics must agree to abs 1e-12, lane
records as `torch_port_helpers.assert_same_records` holds them.  JAX
Runners start from the seeded variables instead of running ``model.init``
(the checkpoint load replaces them either way).
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_helpers import (TINY, assert_same_records, configs,
                                jax_script, random_variables,
                                recorded_validates, seeded_jax_runners,
                                wire_data_root)

# weights whose decodes on this set clear every host decision threshold in
# both packages (the metrics below agree to 1e-12 only if they do)
SEED = 11


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    from lanemapping_tpu_torch.data.synthetic import generate_dataset

    root = str(tmp_path_factory.mktemp("synth"))
    generate_dataset(root, n_tiles=8, img=192, with_params=True)
    return root


@pytest.fixture(scope="module")
def checkpoints(data_root, tmp_path_factory):
    """(JAX checkpoint, port checkpoint, variables) of one seeded set of
    weights at the tiny config."""
    import lanemapping_tpu as lm
    from lanemapping_tpu.engine.checkpoint import save_model as jax_save
    from lanemapping_tpu.engine.runner import Runner as JaxRunner
    from lanemapping_tpu_torch.engine.checkpoint import save_model
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.tools.from_jax import load_jax_weights

    tmp = tmp_path_factory.mktemp("ckpts")
    cfg_j, cfg_t = (wire_data_root(c, data_root) for c in configs(TINY))
    variables = random_variables(lm.build_model(cfg_j),
                                 (jnp.zeros((1, 192, 192, 3)),), SEED)
    with seeded_jax_runners(variables):
        jrun = JaxRunner(cfg_j, log_dir=str(tmp / "jax"))
    jax_save(str(tmp / "jax"), jrun.state, "best")
    trun = Runner(cfg_t, log_dir=str(tmp / "port"), device="cpu")
    load_jax_weights(trun.model, variables["params"],
                     variables["batch_stats"], cfg_t)
    save_model(str(tmp / "port"), trun.state, "best")
    return (str(tmp / "jax" / "ckpt" / "best"),
            str(tmp / "port" / "ckpt" / "best"), variables)


def run_jax_main(script, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{script}.py", *argv])
    mod = jax_script(script)
    mod.main()
    return mod


def test_endp_sweep_matches_jax(data_root, checkpoints, tmp_path,
                                monkeypatch):
    """Every cell of the sweep (the same grid and the same path through
    its three stages), its best cell and recommended defaults equal the
    JAX script's; and the cell at threshold 0.3, radius 10 with
    ``keep_ends``, run through the JAX script's own fused program, equals
    the port's unrounded."""
    from lanemapping_tpu.engine.runner import Runner as JaxRunner
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.tools import endp_sweep

    jckpt, tckpt, variables = checkpoints
    grid = ["--config", TINY, "--data-root", data_root, "--batch", "2",
            "--thres", "0.0", "0.3", "--radii", "10"]
    with seeded_jax_runners(variables), \
            recorded_validates(JaxRunner) as seen:
        run_jax_main("endp_sweep", grid + ["--ckpt", jckpt, "--out",
                                           str(tmp_path / "jax.json")],
                     monkeypatch)
    want = json.load(open(tmp_path / "jax.json"))
    got = endp_sweep.main(grid + ["--ckpt", tckpt, "--out",
                                  str(tmp_path / "port.json"), "--log-dir",
                                  str(tmp_path / "logs"), "--device", "cpu"])
    assert got == json.load(open(tmp_path / "port.json"))
    assert len(got["cells"]) == len(want["cells"]) == 6

    def same_cell(g, w):
        assert set(g) == set(w)
        for k in w:
            if k != "wall_s":
                assert g[k] == pytest.approx(w[k], abs=1e-12), k

    for g, w in zip(got["cells"], want["cells"]):
        same_cell(g, w)
    same_cell(got["best"], want["best"])
    assert got["recommended_defaults"] == want["recommended_defaults"]
    assert max(c["endp_f1"] for c in want["cells"]) > 0.0

    # one cell outside the sweep's path, in both packages
    jrun = seen[-1][2]
    closure = jrun._eval_decode.__code__.co_freevars
    fused = dict(zip(closure, (c.cell_contents for c in
                               jrun._eval_decode.__closure__)))["fused"]
    jrun.cfg.endp_keep_line_ends = True
    jrun.cfg.ref_exact_occupancy_filter = False
    jrun._eval_decode = lambda s, x: fused(s, x, np.float32(0.3),
                                           np.float32(10.0))
    want_cell = jrun.validate()
    runner = Runner(wire_data_root(configs(TINY)[1], data_root),
                    log_dir=str(tmp_path / "cell"), device="cpu")
    from lanemapping_tpu_torch.engine.checkpoint import load_model
    load_model(tckpt, runner.state)
    runner.cfg.batch_size = 2
    runner.cfg.endp_keep_line_ends = True
    runner._eval_decode = endp_sweep.sweep_decode(runner, 0.3, 10.0)
    got_cell = runner.validate()
    assert set(got_cell) == set(want_cell)
    for k in want_cell:
        assert got_cell[k] == pytest.approx(float(want_cell[k]),
                                            abs=1e-12), k
    assert want_cell["coor_f1"] > 0.0


def test_validate_ab_metrics_equal(data_root, checkpoints, tmp_path):
    from lanemapping_tpu_torch.tools import validate_ab

    rec = validate_ab.main(["--config", TINY, "--data-root", data_root,
                            "--ckpt", checkpoints[1], "--batch", "2",
                            "--repeats", "1", "--log-dir", str(tmp_path),
                            "--device", "cpu"])
    assert rec == json.load(open(tmp_path / "validate_ab.json"))
    assert rec["metrics_equal"] is True
    modes = rec["modes"]
    assert set(modes) == {"serial_workers0", "pipelined_workers4"}
    for m in modes.values():
        assert len(m["walls_s"]) == 1 and m["best_wall_s"] > 0
        assert m["coor_f1"] > 0.0
    assert rec["speedup_serial_over_pipelined"] == pytest.approx(
        modes["serial_workers0"]["best_wall_s"]
        / modes["pipelined_workers4"]["best_wall_s"])


def bench_run(value, km):
    return {"metric": "e2e_tiles_per_sec", "value": value,
            "km_lane_per_hour": km, "n_tiles": 16}


@pytest.mark.parametrize("runs", [
    [bench_run(3.25, 10.0), bench_run(1.5, 20.0), bench_run(2.75, 30.0)],
    [bench_run(4.0, 1.0), bench_run(1.0, 2.0), bench_run(3.0, 3.0),
     {"error": "boom", "rc": 1}, bench_run(2.0, 4.0)],
], ids=["odd", "even_and_a_failed_run"])
def test_stream_bench_median_rule_matches_jax(runs, tmp_path, monkeypatch):
    """The headline of the same runs: the JAX script's record (its
    ``run_stream`` and pause stubbed) and the port's ``median_summary``."""
    from lanemapping_tpu_torch.tools import stream_bench

    mod = jax_script("stream_bench")
    calls = iter(runs)
    monkeypatch.setattr(mod, "run_stream", lambda *a, **kw: next(calls))
    monkeypatch.setattr(mod.time, "sleep", lambda s: None)
    monkeypatch.setattr(sys, "argv", [
        "stream_bench.py", "--ckpt", "x", "--runs", str(len(runs)),
        "--out", str(tmp_path / "jax.json")])
    mod.main()
    want = json.load(open(tmp_path / "jax.json"))
    got = stream_bench.median_summary(runs)
    for k in ("value", "unit", "km_lane_per_hour", "runs_tiles_per_sec",
              "best_of_n", "worst_of_n", "n_runs_ok"):
        assert got[k] == want[k], k


def test_stream_bench_runs_on_cpu(data_root, checkpoints, tmp_path):
    """Two ``stream_map --preload`` runs in child processes: the median of
    two is their mean, and every run streamed the trained weights."""
    from lanemapping_tpu_torch.tools import stream_bench

    rec = stream_bench.main(["--config", TINY, "--data-root", data_root,
                             "--ckpt", checkpoints[1], "--runs", "2",
                             "--batch", "2", "--max-batches", "1",
                             "--log-dir", str(tmp_path), "--device", "cpu"])
    assert rec == json.load(open(tmp_path / "stream_bench.json"))
    runs = rec["runs"]
    assert rec["n_runs_ok"] == 2, runs
    vals = [r["value"] for r in runs]
    assert rec["value"] == pytest.approx(0.5 * (vals[0] + vals[1]))
    assert rec["best_of_n"] == max(vals) and rec["worst_of_n"] == min(vals)
    for r in runs:
        assert r["preload"] and r["n_tiles"] == 2 and r["device"] == "cpu"
        assert r["weights"] == os.path.abspath(checkpoints[1])
    assert rec["device"] == "cpu" and "from_las_run" not in rec


def lane_jsons(d):
    return {n[:-5]: json.load(open(os.path.join(d, n)))
            for n in sorted(os.listdir(d))}


def test_export_lane_seqs_matches_jax(data_root, checkpoints, tmp_path):
    from lanemapping_tpu.data.loader import build_dataloader as jax_loader
    from lanemapping_tpu.engine.runner import Runner as JaxRunner
    from lanemapping_tpu.tools.export_lanes import \
        export_lane_seqs as jax_export
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.tools.export_lanes import export_lane_seqs
    from lanemapping_tpu_torch.tools.from_jax import load_jax_weights

    variables = checkpoints[2]
    cfg_j, cfg_t = (wire_data_root(c, data_root) for c in configs(TINY))
    with seeded_jax_runners(variables):
        jrun = JaxRunner(cfg_j, log_dir=str(tmp_path / "jlog"))
    jax_export(jrun, jax_loader(cfg_j.dataset.test, cfg_j, is_train=False),
               str(tmp_path / "jax"))
    runner = Runner(cfg_t, log_dir=str(tmp_path / "tlog"), device="cpu")
    load_jax_weights(runner.model, variables["params"],
                     variables["batch_stats"], cfg_t)
    export_lane_seqs(runner, build_dataloader(cfg_t.dataset.test, cfg_t,
                                              is_train=False),
                     str(tmp_path / "port"))
    want, got = lane_jsons(tmp_path / "jax"), lane_jsons(tmp_path / "port")
    assert list(got) == list(want) and len(want) == 2
    assert_same_records([got[n] for n in want], list(want.values()))
    assert sum(map(len, want.values())) >= 2


@pytest.fixture(scope="module")
def points_root(tmp_path_factory):
    """The 2-tile set of `test_torch_port_lidar_slice.py`, on which its
    image weights clear every decision threshold."""
    from lanemapping_tpu_torch.data.synthetic import generate_dataset

    root = str(tmp_path_factory.mktemp("laserlane"))
    generate_dataset(root, n_tiles=2, img=192, seed=11, with_points=True,
                     points_per_tile=4096)
    return root


def test_stream_map_preload_matches_jax_and_the_plain_run(points_root,
                                                          tmp_path):
    """``--preload`` reads every batch before the timed region and changes
    nothing else: the lane JSONs equal the run without it byte for byte,
    and the JAX chain's records."""
    import torch
    from test_torch_port_lidar_slice import SEEDS, jax_stream_chain
    from torch_port_helpers import assert_clear_of_thresholds, tiny_models

    from lanemapping_tpu_torch.tools import stream_map

    jmodel, variables, tmodel, cfg_j, _ = tiny_models(seed=SEEDS["image"])
    names, dec_j, recs_j = jax_stream_chain(jmodel, variables, cfg_j,
                                            points_root, use_lidar=False)
    assert_clear_of_thresholds(dec_j, cfg_j, clamped_columns=True)
    ckpt = str(tmp_path / "image.pth")
    torch.save(tmodel.state_dict(), ckpt)
    recs = {}
    for how in ("plain", "preload"):
        out = tmp_path / how
        rec = stream_map.main(
            [TINY, points_root, "--split", "infer_only", "--device", "cpu",
             "--ckpt", ckpt, "--out", str(out)]
            + (["--preload"] if how == "preload" else []))
        assert rec["preload"] == (how == "preload") and rec["n_tiles"] == 2
        assert rec["launches"] == {"bev_bin_mean": 0, "voxel_bin_mean": 0}
        recs[how] = lane_jsons(out / "lanes_2d")
    assert recs["preload"] == recs["plain"]
    assert_same_records([recs["preload"][n] for n in names], recs_j)
    assert sum(map(len, recs_j)) >= 2
