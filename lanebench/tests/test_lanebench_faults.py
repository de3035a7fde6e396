"""A run with the timed path broken underneath comes out not correct, and
the control (the reference one precision step below the configuration)
reads far above the program, at a tiny size on the CPU."""

import numpy as np
import pytest

from conftest import run_tiny, tiny_cell


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from lanemapping_tpu_torch.tools import export_lanes
    orig = export_lanes.lane_records

    def altered(ply, *a, **k):
        recs = orig(ply, *a, **k)
        if recs:
            recs[0]["seq"][0][1] += 0.5
        return recs
    monkeypatch.setattr(export_lanes, "lane_records", altered)
    rec = run_tiny(tiny_cell("flagship.serve_las"), seconds=2.0)
    got = {n: v for n, v, _ in rec.checks}
    assert got["json_mismatches"] > 0 and not rec.correct


def test_a_decode_altered_where_it_is_produced(monkeypatch):
    from lanemapping_tpu_torch.tools import stream_map
    orig = stream_map.readback_view

    def altered(out, cfg):
        keep = orig(out, cfg)
        keep["orient"] = keep["orient"] + 1
        return keep
    monkeypatch.setattr(stream_map, "readback_view", altered)
    rec = run_tiny(tiny_cell("flagship.serve_las"), seconds=2.0)
    got = {n: v for n, v, _ in rec.checks}
    assert got["decode_mismatches"] > 0 and not rec.correct


@pytest.mark.parametrize("name", ["flagship.train", "lidar.train"])
def test_a_step_that_leaves_the_state_unchanged(monkeypatch, name):
    import torch
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    rec = run_tiny(tiny_cell(name), seconds=1.0)
    got = {n: v for n, v, _ in rec.checks}
    assert got["change_gap"] == pytest.approx(1.0)
    assert not rec.correct


@pytest.mark.parametrize("name", ["flagship.train", "lidar.train"])
def test_half_of_each_batch_left_out(name):
    """The fault reads ten times a sound run or more on some number, and
    fails limits set at three times the sound run's readings."""
    from lanebench import control, core
    sound = {n: v for n, v, _ in run_tiny(tiny_cell(name),
                                          seconds=1.0).checks}
    cell = tiny_cell(name)
    cell.limits = {k: 3.0 * v for k, v in sound.items()}
    drv = core.loop(cell)
    orig = drv.program_state

    def wrapped(*a, **k):
        cfg, state, step = orig(*a, **k)
        return cfg, state, control.half_batch(step)
    drv.program_state = wrapped
    import time

    import torch
    torch.set_num_threads(2)
    rec = core.Run(cell, 1.0, False)
    rec.device_kind = "cpu"
    drv.run(cell, rec, 3000000019, 1.0, torch.device("cpu"),
            time.perf_counter())
    got = {n: v for n, v, _ in rec.checks}
    assert max(got[k] / max(sound[k], 1e-12) for k in got) >= 10.0, \
        (sound, got)
    assert not rec.correct


@pytest.mark.parametrize("name", ["flagship.train", "lidar.train",
                                  "flagship.serve_las"])
def test_the_control_reads_far_above_the_program(name):
    """The control fails a number the program passes by three times or
    more, and `control.py` judges it not correct against limits set at
    three times the program's readings, as it judges the half-batch fault:
    at a tiny size on the CPU, where the program itself computes without
    TF32."""
    import torch

    from lanebench import control
    cell = tiny_cell(name)
    rec = run_tiny(cell, seconds=2.0)
    prog = {**{n: v for n, v, _ in rec.checks},
            **rec.notes.get("readings", {})}
    cell.limits = {k: 3.0 * v for k, v in prog.items()
                   if k not in ("decode_mismatches", "json_mismatches")}
    torch.set_num_threads(2)
    level = "bfloat16" if cell.config.get("use_lidar") else "float8"
    line = control.seed_line(cell, 3000000019, torch.device("cpu"), level,
                             1.0, program=False, faults=True)
    ctrl = line["control"]
    ratios = {k: ctrl[k] / max(prog[k], 1e-12) for k in ctrl if k in prog}
    assert max(ratios.values()) >= 3.0, (prog, ctrl)
    assert np.isfinite([v for k, v in ctrl.items()
                        if k != "worst_leaf"]).all()
    assert line["control_correct"] is False, line["control_checks"]
    assert set(line["control_checks"]) == set(cell.limits) & set(ctrl)
    if cell.traffic["loop"] == "train":
        assert line["half_batch_correct"] is False
