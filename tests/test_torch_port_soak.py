"""The port's soak tool and endpoint-sigma regeneration against the JAX
root scripts (`tools/soak_run.py`, `tools/regen_endp_sigma.py`, loaded
with ``importlib`` from their paths), on the CPU at ``configs/tiny_test.py``
over an 8-tile synthetic set with transform params.

Weights are numpy-seeded flax variables; the JAX soak reads them from a
JAX checkpoint (`engine/checkpoint.py::save_model`), the port's soak from
a port checkpoint of the same weights carried by `tools/from_jax.py`.
Validation metrics must agree to abs 1e-12.  Building a JAX Runner runs
``model.init``, which costs more than the rest of a validation here, so
the JAX Runner's initial state is built from the seeded variables instead
(the checkpoint load replaces it either way).
"""

import filecmp
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (REPO, TINY, TINY_LIDAR, jax_script,
                                random_variables, recorded_validates,
                                seeded_jax_runners)

# weights whose decodes on this set clear every host decision threshold in
# both packages (the metrics below agree to 1e-12 only if they do)
SEED = 11


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    from lanemapping_tpu_torch.data.synthetic import generate_dataset

    root = str(tmp_path_factory.mktemp("synth"))
    generate_dataset(root, n_tiles=8, img=192, with_params=True)
    return root


def soak_args(root, log_dir, *extra):
    """The port soak's arguments; the JAX soak gets the same values."""
    from lanemapping_tpu_torch.tools import soak_run
    return soak_run.parse_args(["--config", TINY, "--data-root", root,
                                "--log-dir", str(log_dir), "--batch", "2",
                                "--epochs", "1", "--eval-ep", "1",
                                "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def checkpoints(data_root, tmp_path_factory):
    """(JAX checkpoint, port checkpoint, variables) of one seeded set of
    weights, each written by its package's Runner of the soak's config."""
    import lanemapping_tpu as lm
    from lanemapping_tpu.engine.checkpoint import save_model as jax_save
    from lanemapping_tpu.engine.runner import Runner as JaxRunner
    from lanemapping_tpu_torch.engine.checkpoint import save_model
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.tools import soak_run
    from lanemapping_tpu_torch.tools.from_jax import load_jax_weights

    tmp = tmp_path_factory.mktemp("ckpts")
    args = soak_args(data_root, tmp)
    cfg_j = jax_script("soak_run")._train_cfg(args)
    cfg_t = soak_run._train_cfg(args)
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


def test_regen_endp_sigma_writes_the_jax_pngs(data_root, tmp_path,
                                              monkeypatch):
    from lanemapping_tpu_torch.tools import regen_endp_sigma

    jdst, tdst = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["regen_endp_sigma.py", "--src",
                                      data_root, "--dst", jdst, "--sigma",
                                      "3", "--img", "192"])
    jax_script("regen_endp_sigma").main()
    n = regen_endp_sigma.main(["--src", data_root, "--dst", tdst, "--sigma",
                               "3", "--img", "192"])
    assert n == 8
    rel = os.path.join("labels", "sparse_endp")
    names = sorted(os.listdir(os.path.join(jdst, rel)))
    assert names == sorted(os.listdir(os.path.join(tdst, rel)))
    assert len(names) == 8
    for name in names:
        assert filecmp.cmp(os.path.join(jdst, rel, name),
                           os.path.join(tdst, rel, name), shallow=False), name
    # the sigma-3 maps differ from the set's sigma-2 ones
    assert not filecmp.cmp(os.path.join(data_root, rel, names[0]),
                           os.path.join(tdst, rel, names[0]), shallow=False)
    for d in (jdst, tdst):
        links = sorted(os.path.relpath(os.path.join(p, f), d)
                       for p, ds, fs in os.walk(d) for f in ds + fs
                       if os.path.islink(os.path.join(p, f)))
        assert links == ["cropped_tiff", "cropped_tiff_param",
                         "data_split-shuffle.json",
                         os.path.join("labels", "sparse_instance"),
                         os.path.join("labels", "sparse_orient"),
                         os.path.join("labels", "sparse_semantic"),
                         os.path.join("labels", "sparse_seq")]


@pytest.mark.parametrize("overrides", [[], ["epochs=3", "batch_size=2"],
                                       ["epochs=3", "total_iter=5"]])
def test_train_cfg_matches_jax(data_root, tmp_path, overrides):
    """The soak's config: the same values in both packages, and an
    ``epochs``/``batch_size`` override re-derives the schedule's length
    unless ``total_iter`` is pinned."""
    from lanemapping_tpu_torch.tools import soak_run

    extra = [a for o in overrides for a in ("--set", o)]
    args = soak_args(data_root, tmp_path, "--batch", "4", *extra)
    cfg_j = jax_script("soak_run")._train_cfg(args)
    cfg_t = soak_run._train_cfg(args)
    assert cfg_t.to_dict() == cfg_j.to_dict()
    assert cfg_t.train_compute_dtype == "bfloat16" and cfg_t.gt_cache
    n_train = 4  # 0.6 of 8 tiles
    want = {(): n_train // 4 * 1, ("epochs=3", "batch_size=2"):
            n_train // 2 * 3, ("epochs=3", "total_iter=5"): 5}[
        tuple(overrides)]
    assert cfg_t.total_iter == want
    assert cfg_t.scheduler["T_max"] == (want if "total_iter=5" not in
                                        overrides else n_train // 4 * 1)


@pytest.mark.parametrize("overrides", [
    {}, {"ref_exact_occupancy_filter": True}, {"endp_decode": "exact_host"}],
    ids=["default", "ref_exact_occupancy", "exact_host"])
def test_validate_with_matches_jax(data_root, checkpoints, tmp_path,
                                   overrides):
    from lanemapping_tpu.engine.runner import Runner as JaxRunner
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.tools import soak_run

    jckpt, tckpt, variables = checkpoints
    args = soak_args(data_root, tmp_path)
    with seeded_jax_runners(variables), \
            recorded_validates(JaxRunner, Runner) as seen:
        want = jax_script("soak_run")._validate_with(args, jckpt, overrides)
        got = soak_run._validate_with(args, tckpt, overrides)
    assert [s[0] for s in seen] == ["lanemapping_tpu.engine.runner",
                                    "lanemapping_tpu_torch.engine.runner"]
    raw_j, raw_t = seen[0][1], seen[1][1]
    assert set(raw_t) == set(raw_j)
    assert {"coor_f1", "endp_f1", "composite", "semantic_f1"} <= set(raw_j)
    for k in raw_j:
        assert raw_t[k] == pytest.approx(float(raw_j[k]), abs=1e-12), k
    assert set(got) == set(want)
    for k in want:
        if k != "wall_s":
            assert got[k] == pytest.approx(want[k], abs=1e-12), k
    # a pass that decodes nothing would agree trivially
    assert raw_j["coor_f1"] > 0.0 and raw_j["endp_f1"] > 0.0
    # the soak never saves a "best" from an evaluation
    assert not os.path.exists(tmp_path / "eval_tmp" / "ckpt")


def test_soak_train_and_stream_run_on_cpu(data_root, tmp_path):
    """Stages train (2 steps of batch 2) and stream end to end: a merged
    global map that is not empty, and the stage records' keys of the JAX
    soak (its record `SOAK_RUN.json`, written by the same stages)."""
    from lanemapping_tpu_torch.tools import soak_run

    rec = soak_run.main(["--config", TINY, "--data-root", data_root,
                         "--log-dir", str(tmp_path), "--batch", "2",
                         "--epochs", "1", "--eval-ep", "1", "--stages",
                         "train,stream", "--stream-batches", "1",
                         "--device", "cpu"])
    assert rec == json.load(open(tmp_path / "soak_run.json"))
    with open(os.path.join(REPO, "SOAK_RUN.json")) as f:
        jax_rec = json.load(f)
    assert set(rec) == {"provenance", "launches", "train", "stream_bev"}
    zero = {"bev_bin_mean": 0, "voxel_bin_mean": 0}  # no kernel on the CPU
    assert rec["launches"] == {"train": zero, "stream": zero}
    assert rec["provenance"]["device"] == "cpu"
    for stage in ("train", "stream_bev"):
        assert set(rec[stage]) == set(jax_rec[stage]), stage
    train = rec["train"]
    assert train["steps"] == 2 and len(train["val_curve"]) == 1
    assert train["best_composite"] == train["val_curve"][0]["composite"]
    assert os.path.isfile(os.path.join(train["ckpt"], "state.pt"))
    stream = rec["stream_bev"]
    assert stream["rc"] == 0 and stream["merged_lines"] > 0
    assert stream["bench"]["preload"] and stream["bench"]["n_tiles"] == 8
    assert stream["bench"]["weights"] == os.path.abspath(train["ckpt"])
    assert np.isfinite(stream["bench"]["value"])
    with open(stream["merged_map"]) as f:
        rows = [list(map(float, line.split())) for line in f]
    assert rows and np.isfinite(rows).all()


def test_soak_tools_default_to_cuda(data_root, tmp_path):
    """Every checkpoint tool takes ``--device`` (default ``cuda``) and
    raises on a machine without a card rather than carrying on."""
    from lanemapping_tpu_torch.tools import (endp_sweep, soak_run,
                                             stream_bench, validate_ab)

    base = ["--data-root", data_root, "--log-dir", str(tmp_path)]
    tools = {soak_run: base, endp_sweep: base + ["--ckpt", "x"],
             validate_ab: base + ["--ckpt", "x"],
             stream_bench: base + ["--ckpt", "x"]}
    for tool, argv in tools.items():
        assert tool.parse_args(argv).device == "cuda", tool.__name__
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                tool.main(argv)
    if not torch.cuda.is_available():
        assert os.listdir(tmp_path) == []


def test_load_config_and_runner(tmp_path):
    from lanemapping_tpu_torch.engine.runner import Runner, \
        load_config_and_runner

    cfg, runner = load_config_and_runner(TINY, log_dir=str(tmp_path),
                                         device="cpu")
    assert isinstance(runner, Runner) and runner.cfg is cfg
    assert runner.device.type == "cpu" and runner.log_dir == str(tmp_path)
    assert cfg.list_img_size_xy == [192, 192]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_config_and_runner(TINY, log_dir=str(tmp_path))


def test_soak_lidar_stages_run_on_cpu(tmp_path):
    """The LiDAR soak's stages at ``configs/tiny_test_lidar.py``: train
    (one step of batch 2), the reference-exact LiDAR flags, and the LiDAR
    stream of the trained checkpoint in a child process, with the JAX
    soak's record keys."""
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    from lanemapping_tpu_torch.tools import soak_run

    root = str(tmp_path / "lidar")
    generate_dataset(root, n_tiles=4, img=192, seed=11, with_points=True,
                     points_per_tile=4096)
    rec = soak_run.main(["--config", TINY_LIDAR, "--lidar-config",
                         TINY_LIDAR, "--data-root", root, "--lidar-root",
                         root, "--lidar-points", "4096", "--log-dir",
                         str(tmp_path / "log"), "--batch", "2", "--epochs",
                         "1", "--eval-ep", "1", "--stages",
                         "train,refkit_lidar,lidar", "--device", "cpu"])
    assert rec["train"]["steps"] == 1
    ref = rec["ref_exact_lidar"]
    assert set(ref) == {"ckpt", "default", "voxel_cap_first10",
                        "bicubic_upsample"}
    assert ref["default"]["composite"] == rec["train"]["best_composite"]
    lidar = rec["stream_lidar"]
    assert lidar["rc"] == 0, lidar.get("stderr_tail")
    # the JAX script's entry; its record `SOAK_RUN_LIDAR.json` adds notes
    assert set(lidar) == {"wall_s", "bench", "rc", "points_per_tile", "ckpt",
                          "points_per_sec"}
    assert lidar["ckpt"] == rec["train"]["ckpt"]
    bench = lidar["bench"]
    assert bench["input"] == "lidar" and bench["n_tiles"] == 4
    assert bench["points_per_tile"] == 4096
    assert bench["weights"] == os.path.abspath(rec["train"]["ckpt"])
    assert lidar["points_per_sec"] == round(bench["value"] * 4096, 0)
