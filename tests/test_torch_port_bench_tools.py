"""The port's measurement tools around the benchmark, on the CPU:
`tools/profile_train.py`'s trace aggregation on hand-built traces,
`tools/train_mfu_sweep.py`'s cells (parsed, failed and run), and
`tools/config_smoke.py` at ``configs/tiny_test.py`` with the entry keys of
the root script's ``smoke_one``.
"""

import ast
import json
import os
import sys

import pytest
from torch_port_helpers import REPO, TINY


def kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7}


def host(name, ts, dur):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1}


# a window of 100 us: host ops from 0 to 100; kernels on two streams, the
# second overlapping the first from 30 to 40, a gap from 60 to 70
TRACE = {"traceEvents": [
    host("aten::conv2d", 0.0, 100.0),
    host("aten::add_", 50.0, 5.0),
    {"ph": "M", "name": "process_name", "pid": 0,
     "args": {"name": "GPU 0"}},
    {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 12.0, "pid": 0},
    kernel("sm90_xmma_fprop_implicit_gemm_bf16", 10.0, 30.0),
    kernel("sm90_xmma_fprop_implicit_gemm_bf16", 40.0, 10.0),
    kernel("nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NNT", 30.0, 10.0),
    kernel("void at::native::vectorized_elementwise_kernel<4, "
           "at::native::AddFunctor<float>>", 50.0, 10.0),
    kernel("Memcpy HtoD (Pageable -> Device)", 70.0, 5.0, "gpu_memcpy"),
    kernel("void at::native::batch_norm_collect_statistics_kernel", 75.0,
           5.0),
    kernel("band_scatter_kernel", 80.0, 10.0),
    kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 90.0, 5.0),
    kernel("void mystery_kernel<8>", 95.0, 5.0),
    {"ph": "X", "cat": "gpu_user_annotation", "name": "ProfilerStep",
     "ts": 10.0, "dur": 90.0, "pid": 0, "tid": 7},
]}


def test_profile_sums_by_name_and_category():
    from lanemapping_tpu_torch.tools.profile_train import \
        device_time_by_kernel

    agg = device_time_by_kernel(TRACE, top_n=3)
    assert agg["device_total_us"] == 90.0
    top = agg["top_ops"]
    assert [r["name"] for r in top] == [
        "sm90_xmma_fprop_implicit_gemm_bf16",
        "nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NNT",
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::AddFunctor<float>>"]
    assert (top[0]["total_us"], top[0]["calls"]) == (40.0, 2)
    cats = {r["name"]: r["total_us"] for r in agg["by_category"]}
    assert cats == {"convolution": 40.0, "gemm": 10.0, "elementwise": 10.0,
                    "copy_cast": 5.0, "reduction": 5.0, "port_kernels": 10.0,
                    "nccl": 5.0, "other": 5.0}
    assert sum(r["pct"] for r in agg["by_category"]) == pytest.approx(100.0)
    assert top[0]["pct"] == pytest.approx(100.0 * 40.0 / 90.0)


def test_profile_busy_share_counts_overlap_once():
    from lanemapping_tpu_torch.tools.profile_train import (
        device_time_by_kernel, union_us)

    agg = device_time_by_kernel(TRACE)
    # kernels cover [10, 60) and [70, 100): 80 us of a 100 us window,
    # though their durations sum to 90
    assert agg["device_busy_us"] == 80.0
    assert agg["traced_window_us"] == 100.0
    assert agg["device_busy_share"] == pytest.approx(0.8)
    assert union_us([(0, 5), (1, 2), (4, 9), (20, 21)]) == 10
    assert union_us([]) == 0.0
    empty = device_time_by_kernel({"traceEvents": [host("a", 0.0, 3.0)]})
    assert empty["device_total_us"] == 0.0 and empty["top_ops"] == []
    assert empty["device_busy_share"] == 0.0


def test_profile_parse_only_writes_the_record(tmp_path):
    from lanemapping_tpu_torch.tools import profile_train

    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps(TRACE))
    rec = profile_train.main(["--parse-only", "--trace", str(trace),
                              "--log-dir", str(tmp_path), "--steps", "2"])
    assert rec["per_step_ms"] == pytest.approx(90.0 / 1e3 / 2)
    with open(tmp_path / "profile_train.json") as f:
        assert json.load(f)["device_busy_share"] == pytest.approx(0.8)
    assert "gb_per_s" in rec["not_measured"]
    with pytest.raises(SystemExit, match="needs --device cuda"):
        profile_train.main(["--device", "cpu", "--log-dir", str(tmp_path)])


def test_sweep_parses_a_cell_and_records_a_failed_one():
    from lanemapping_tpu_torch.tools.train_mfu_sweep import (bench_cmd,
                                                             best_cells,
                                                             parse_cell)

    rec = {"metric": "train_sec_per_step", "value": 0.2, "train_mfu": 0.11,
           "tiles_per_sec_train": 40.0, "step_flops": 1.9e13,
           "hbm_highwater_gb": 15.3}
    out = "[log] warm-up\n" + json.dumps(rec) + "\n"
    cell = parse_cell(8, "none", 0, out, "", 12.5)
    assert cell == {"batch": 8, "remat_policy": "none", "wall_s": 12.5,
                    "sec_per_step": 0.2, "train_mfu": 0.11,
                    "tiles_per_sec_train": 40.0, "step_flops": 1.9e13,
                    "hbm_highwater_gb": 15.3}
    oom = parse_cell(16, "none", 1, out[:10], "torch.OutOfMemoryError: "
                     "CUDA out of memory", 30.0, sets="s2d_stem=True")
    assert oom["rc"] == 1 and "out of memory" in oom["error"] and oom["oom"]
    assert oom["set"] == "s2d_stem=True" and "sec_per_step" not in oom
    no_record = parse_cell(4, "full", 0, "no record", "", 1.0)
    assert "error" in no_record and not no_record["oom"]
    best = best_cells([cell, oom, dict(cell, batch=4, train_mfu=0.05,
                                       tiles_per_sec_train=50.0)])
    assert best["best_mfu"]["batch"] == 8
    assert best["best_tiles_per_sec"]["batch"] == 4
    assert best_cells([oom]) == {}
    cmd = bench_cmd(4, "dots", 3, "a=1;b=2")
    assert cmd[1:] == ["-m", "lanemapping_tpu_torch.tools.bench", "--train",
                       "--batch", "4", "--iters", "3", "--device", "cuda",
                       "--remat", "--remat-policy", "dots", "--set",
                       "a=1;b=2"]
    assert "--no-remat" in bench_cmd(4, "none", 3)
    assert bench_cmd(64, None, None, extra=["--warmup", "1"])[1:] == [
        "-m", "lanemapping_tpu_torch.tools.bench", "--batch", "64",
        "--device", "cuda", "--warmup", "1"]
    serve = parse_cell(64, None, 0, json.dumps(
        {"value": 219.9, "unit": "tiles/s", "ms_per_pass": 291.0,
         "digest_mean": 466.4, "hbm_highwater_gb": 21.8}), "", 9.0)
    assert serve == {"batch": 64, "remat_policy": None, "wall_s": 9.0,
                     "tiles_per_sec": 219.9, "ms_per_pass": 291.0,
                     "digest_mean": 466.4, "hbm_highwater_gb": 21.8}


def test_sweep_runs_cells_in_children_and_records_a_failure(tmp_path):
    """One cell on the CPU at the tiny config runs; a cell that asks for
    the card on a machine with none fails in its child and is recorded."""
    from lanemapping_tpu_torch.tools import train_mfu_sweep

    rec = train_mfu_sweep.main([
        "--batches", "2", "--policies", "none", "--also-none-at", "0",
        "--iters", "1", "--config", TINY, "--device", "cpu",
        "--log-dir", str(tmp_path)])
    (cell,) = rec["cells"]
    assert cell["batch"] == 2 and cell["sec_per_step"] > 0
    assert cell["train_mfu"] is None and cell["step_flops"] > 0
    assert rec["best_mfu"] == cell == rec["best_tiles_per_sec"]
    assert rec["device"] == "cpu"
    with open(tmp_path / "train_mfu_sweep.json") as f:
        assert json.load(f)["cells"] == rec["cells"]
    failed = train_mfu_sweep.run_cell(2, "full", 1, device="cuda",
                                      config=TINY)
    assert failed["rc"] != 0 and "CUDA" in failed["error"]


def jax_smoke_entry_keys():
    """The keys of the root `tools/config_smoke.py`'s entry: its
    ``smoke_one`` dict, and the ``provenance`` its ``main`` adds."""
    with open(os.path.join(REPO, "tools", "config_smoke.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "smoke_one")
    entry = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "entry")
    return {k.value for k in entry.keys} | {"provenance"}


def test_config_smoke_on_the_cpu(tmp_path, monkeypatch):
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.tools import config_smoke

    # no TensorBoard writer (its import pulls in TensorFlow here)
    monkeypatch.setattr(Runner, "_tb", None, raising=False)
    root = str(tmp_path / "data")
    generate_dataset(root, n_tiles=8, img=192)
    out = tmp_path / "logs" / "config_smoke.json"
    rec = config_smoke.main([
        "--data-root", root, "--configs", "no_such_config", TINY,
        "--steps", "3", "--batch", "2", "--val-batches", "1", "--log-dir",
        str(tmp_path / "logs"), "--device", "cpu"])
    assert list(rec["configs"]) == ["no_such_config", "tiny_test"]
    assert "FileNotFoundError" in rec["configs"]["no_such_config"]["error"]
    entry = rec["configs"]["tiny_test"]
    assert set(entry) == jax_smoke_entry_keys()
    assert entry["steps"] == 3 and entry["sec_per_step"] > 0
    assert {"coor_f1", "composite"} <= set(entry["val"])
    assert entry["provenance"]["device"] == "cpu"
    with open(out) as f:
        assert json.load(f) == rec
    # a second run merges: earlier entries stay
    again = config_smoke.main([
        "--data-root", root, "--configs", "no_such_config", "--log-dir",
        str(tmp_path / "logs"), "--device", "cpu"])
    assert again["configs"]["tiny_test"] == entry


def test_tools_take_device_and_default_to_cuda():
    from lanemapping_tpu_torch.tools import (bench, config_smoke,
                                             profile_train, train_mfu_sweep)

    assert bench.parse_args([]).device == "cuda"
    assert profile_train.parse_args([]).device == "cuda"
    assert train_mfu_sweep.parse_args([]).device == "cuda"
    assert config_smoke.parse_args(["--data-root", "r"]).device == "cuda"
    assert sys.modules["lanemapping_tpu_torch.tools.bench"] is bench
